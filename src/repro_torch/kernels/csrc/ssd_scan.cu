// Chunked SSD (Mamba2) scan, B/C shared across heads, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_pallas, body _kernel): x (B,S,H,P), log-decay a (B,S,H),
// bmat and cmat (B,S,N) shared by the H heads, incoming state h0
// (B,H,P,N) f32.  Per (b, h), over chunks of Q steps in order, with
// cum = inclusive cumsum of a inside the chunk and total = cum[Q-1]:
//
//   y = e^{cum} (C h^T) + ((C B^T) o e^{cum_q - cum_k} [k <= q]) x
//   h <- e^{total} h + (B e^{total - cum})^T x
//
// y comes back in x's type, h_final in f32; x, a and B/C may each be
// f32 or bf16, all arithmetic is f32 but the cumsum.  On the zamba2-2.7b
// serving path it runs once per Mamba2 layer per prefill (54 calls), x
// (B,S,80,64), B/C (B,S,64), Q = min(128, S).
//
// What bounds it.  Per (b, h) and chunk: 2QPN for C h^T, 2QPN for the
// state update, and 2P + 1 for each causal (q, k) pair (the decay and
// the product with x).  The scores C B^T do not depend on the head: the
// function needs their 2N per causal pair once per batch row.  At B = 8,
// S = Q = 128, H = 80, P = N = 64: 2.03 GFLOP.  The products run on the
// tensor cores at f32 precision (3xTF32, below: three TF32 operations
// per f32 one), so the least time is max(bytes / 3.35 TB/s, 3 *
// operations / 495 TFLOP/s) = max(19.03, 12.32) us: bound by the 63.8
// MB of x, y, a, B, C, h0 and h_final (chip_smoke.py's ssd_bound).
//
// Design.
// - The grid (H, B): one block of 8 warps owns one (b, h) and loops
//   over its chunks with h in shared memory, as the Pallas grid (B, H,
//   S/Q) runs the chunk axis in order on one core and carries h in VMEM.
//   640 blocks at B = 8; 188.5 KB of shared memory at Q = 128, P = N =
//   64, so one block an SM.
// - The chunk by cp.async in two groups: B and C, which the scores need
//   first, then x (and h0 with the first chunk), in 16-byte pieces where
//   rows and pointers allow (else 8 or 4; a bf16 row of odd length
//   element by element).  The scores run while x and h land.  Warp 0
//   reads a with four loads a lane in flight, sums it in f64 (four steps
//   a lane in order, then one scan over the lanes) and keeps cum as an
//   f32 pair hi + lo: at the path's decays -cum reaches ~100, where an
//   f32 cum is off by several ulps of 100 and every decay with it.  A
//   decay is the exponential of (hi_q - hi_k) + (lo_q - lo_k), taken only
//   where k <= q; never e^{cum_q} e^{-cum_k}, which overflows f32 once
//   -cum passes ~88.
// - All four products on mma.sync m16n8k8 TF32 with f32 accumulation,
//   each f32 operand split into hi = rna(x) and lo = rna(x - hi) and a
//   product taken as lo*hi + hi*lo + hi*hi (3xTF32, flash_attention.cu's
//   helpers), each round over all the accumulators before the next; a
//   bf16 operand is exact in TF32 and drops its round.  Plain TF32
//   (hi*hi alone) misses the 3e-5 tolerance, and so does any one of the
//   four products alone on it (tests/test_torch_ssd_scan.py emulates the
//   kernel's arithmetic).  The scores S = C B^T are masked and decayed
//   into a score tile Ps in shared memory; y = e^{cum} (C h^T) + Ps x,
//   C h^T taken into the accumulators first and scaled row by row; the
//   state update starts its accumulators from e^{total} h.
// - The causal triangle.  Query rows are m-tiles of 16; warp w owns
//   m-tiles a = w % 4 and 7 - a, whose keys together are 18 groups of 8
//   for every w, and output columns 32 (w / 4) .. + 31; the two warps of
//   a pair take the scores of alternate key groups.  A group past a
//   tile's diagonal is skipped, the diagonal 16 x 16 block masked.  For
//   the state update warp w owns a 16 x 32 piece of h.
// - Shared-memory rows are the padded width plus 16 bytes, 4 words mod
//   32, so a warp's fragment reads of (row g, column t) and of (row 2t or
//   2t + 1, column g) hit 32 banks; keys (and the state update's steps)
//   are renumbered in each group of 8 (k-index t is key 2t, t + 4 is key
//   2t + 1), so a lane's two scores of a row are one 8-byte access.  Q
//   pads to 16, P to 64, N to 32, with zeros.
// - Code size.  A warp's scores run in chunks of at most 4 key groups,
//   four straight-line bodies in all, and no loop is unrolled: with a
//   body for each of 1..8 groups and loops unrolled twice the kernel
//   took 162 us, not 122.  Those changes only shrank the code, so the
//   likely cause is the instruction cache (no profiler here shows it).
//
// Registers (build.build_log): 155-162 a thread in the 8 instantiations,
// no spills.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; tools/check_ssd_decays.py
// at x (8,128,80,64), B/C (8,128,64), Q = 128, f32, CUDA graph,
// L2-warm; each version beside the parent in one call; PERF.md):
//   the SIMT kernel it replaces (the parent)              253.1-255.8 us
//   1. the chunk by cp.async, products still SIMT          221.5-223.1
//   2. + the four products on 3xTF32 mma.sync              168.4-169.9
//   3. + warps balanced over the causal triangle            161.9-164.2
//   4. + scores in chunks of <= 4 groups, no unrolling,
//      one f64 scan                                         122.1-122.3
//   5. + copy indices stepped, h_final in 16-byte stores    115.7-116.6
// That is 6.1x the bound.  Without its products (mma.sync and the splits
// removed) the kernel takes 54.9-55.2 us: the loads, the cumsum and the
// stores of one block an SM, which nothing overlaps; plain TF32 (one
// round) would save 34 us of version 4's 122.  Against the float64
// recurrence at the path's decays, over 32 seeds, the kernel is at most
// 0.32x the plain version's distance (the parent 0.15x).
//
// What a later design would change: the scores once per batch row and
// chunk, shared by its H heads (here each of the 80 blocks recomputes
// them, a quarter of the products); two blocks an SM (at most 113 KB of
// shared memory and 128 registers), so one block's loads and stores
// overlap another's products; P kept in registers with
// flash_attention.cu's key renumbering instead of the round trip
// through Ps; wgmma with a TMA producer warp for the card's full TF32
// rate; and the next chunk's x, B and C prefetched while this one
// computes when S > Q.
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, the kernel is launched on that stream,
// and the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKB = 128;  // query rows and keys of a score tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Two neighbouring outputs: one 8-byte (f32) or 4-byte (bf16) store.
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties
// away from zero: +0x1000 on the bit pattern, low 13 bits cleared), in
// two integer operations, which the card runs faster than the cvt.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value (exact: hi alone).
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (kExact) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  }
}

// d += a * b: one m16n8k8 TF32 product, f32 accumulation.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a * b[j] for NT n-tiles at f32 precision (3xTF32): lo*hi,
// hi*lo, hi*hi, small terms first, each round over all NT accumulators
// before the next, so no product waits on the one before.  A round whose
// lo is 0 (an operand exact in TF32, bf16) is left out.
template <bool kExA, bool kExB, int NT>
__device__ __forceinline__ void mma3(float (&d)[NT][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[NT][2],
                                     const uint32_t (&bl)[NT][2]) {
  if constexpr (!kExA) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(d[j], al, bh[j]);
  }
  if constexpr (!kExB) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma(d[j], ah, bl[j]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) mma(d[j], ah, bh[j]);
}

// 16 bytes global -> shared, asynchronous (as flash_attention.cu's),
// and its 8- and 4-byte forms.
template <int V>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(V));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `rows` rows of `cols` elements, row r from g + r * ld to s + r * ss,
// in pieces of V bytes (16, 8 or 4, chosen by the launcher so that every
// piece is aligned); V = 0, for rows whose bytes are not a multiple of 4
// (bf16 rows of odd length), copies element by element.
template <typename T>
__device__ __forceinline__ void copy_rows(T* s, int ss, const T* g,
                                          size_t ld, int rows, int cols,
                                          int V, int tid) {
  if (V == 0) {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e - r * cols;
      s[r * ss + c] = g[r * ld + c];
    }
    return;
  }
  // thread tid takes pieces tid, tid + kThreads, ...: (row, piece) is
  // stepped, not divided anew, from one to the next
  const int per = V / (int)sizeof(T), pieces = cols / per;
  const int dr = kThreads / pieces, dc = kThreads % pieces;
  for (int r = tid / pieces, c = tid % pieces; r < rows;) {
    T* d = s + r * ss + c * per;
    const T* src = g + r * ld + c * per;
    if (V == 16)
      cp_async<16>(d, src);
    else if (V == 8)
      cp_async<8>(d, src);
    else
      cp_async<4>(d, src);
    r += dr;
    c += dc;
    if (c >= pieces) {
      c -= pieces;
      ++r;
    }
  }
}

// rows x cols floats from s (row stride ss) to g (rows ld apart), in
// pieces of V bytes (16, 8 or 4), stepped as in copy_rows.
__device__ __forceinline__ void store_rows(float* g, size_t ld,
                                           const float* s, int ss, int rows,
                                           int cols, int V, int tid) {
  const int per = V / 4, pieces = cols / per;
  const int dr = kThreads / pieces, dc = kThreads % pieces;
  for (int r = tid / pieces, c = tid % pieces; r < rows;) {
    float* d = g + r * ld + c * per;
    const float* src = s + r * ss + c * per;
    if (V == 16)
      *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src);
    else if (V == 8)
      *reinterpret_cast<float2*>(d) = *reinterpret_cast<const float2*>(src);
    else
      *d = *src;
    r += dr;
    c += dc;
    if (c >= pieces) {
      c -= pieces;
      ++r;
    }
  }
}

// Zero the entries of a rows_p x cols_p array (row stride ss) outside
// its rows x cols corner: the padding the tiles read.
template <typename T>
__device__ __forceinline__ void zero_pad(T* s, int ss, int rows, int cols,
                                         int rows_p, int cols_p, int tid) {
  if (rows == rows_p && cols == cols_p) return;
  for (int e = tid; e < rows_p * cols_p; e += kThreads) {
    const int r = e / cols_p, c = e - r * cols_p;
    if (r >= rows || c >= cols) s[r * ss + c] = from_f32<T>(0.f);
  }
}

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Shared memory of a block.  Q pads to Qp (16-row m-tiles), P to Pp
// (64-wide output pieces), N to Np (32-wide state pieces), with zeros.
// Row strides are the padded width plus 16 bytes: rows stay 16-byte
// aligned and the stride is 4 words mod 32 (f32; bf16 at Np, Pp = 64),
// so a warp's fragment reads (row g, column t) and (row 2t or 2t+1,
// column g) fall in 32 different banks.  The score tile, kb = min(Qp,
// 128) rows of kb keys, has stride kb + 8 (8 words mod 32 at kb = 128):
// a lane's two neighbouring scores (row g, keys 2t, 2t + 1) are one
// 8-byte access, conflict-free.  Byte offsets: B and C [Qp] (TB), x [Qp]
// (TX), h [Pp] (f32), the scores [kb] (f32), then cum = hi + lo and w =
// e^{total - cum}, each [Qp] (f32).
struct Layout {
  int qp, pp, np, sb, sx, sh, sp;
  int b, c, x, h, p, hi, lo, w, bytes;
  __host__ __device__ Layout(int Q, int P, int N, int xsize, int bsize)
      : qp(round_up(Q, 16)), pp(round_up(P, 64)), np(round_up(N, 32)),
        sb(np + 16 / bsize), sx(pp + 16 / xsize), sh(np + 4),
        sp((qp < kKB ? qp : kKB) + 8) {
    b = 0;
    c = b + qp * sb * bsize;
    x = c + qp * sb * bsize;
    h = x + qp * sx * xsize;
    p = h + pp * sh * 4;
    hi = p + (sp - 8) * sp * 4;
    lo = hi + qp * 4;
    w = lo + qp * 4;
    bytes = w + qp * 4;
  }
};

// (hi_a + lo_a) - (hi_b + lo_b), off by an ulp of the result
__device__ __forceinline__ float diff2(float hi_a, float lo_a, float hi_b,
                                       float lo_b) {
  return (hi_a - hi_b) + (lo_a - lo_b);
}

// Scores of the query rows [r0, r0 + 16) against G groups of 8 keys,
// group i at keys k0 + 16 i (every other group of the key block: the
// two warps that share an m-tile take one parity each), S = C B^T (M =
// query, K = n, N = key), masked (k <= q, k < Q) and decayed by
// e^{cum_q - cum_k}, into the rows Pr of the score tile (key k at
// column k - kb0).  A (C): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
// (g+8, t+4); B (B): b0 = B[key g][n t], b1 = B[key g][n t+4].
template <int G, typename TB>
__device__ __forceinline__ void scores(float* Pr, int sps, const TB* Cs,
                                       const TB* Bs, int SB, int nks, int r0,
                                       int k0, int kb0, const float* hi,
                                       const float* lo, int Q, int g,
                                       int t) {
  constexpr bool kEx = kIsBf16<TB>;
  float s[G][4];
#pragma unroll
  for (int i = 0; i < G; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
  const TB* cp = Cs + (r0 + g) * SB + t;
  const TB* bp = Bs + (k0 + g) * SB + t;
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t ah[4], al[4], bh[G][2], bl[G][2];
    split<kEx>(to_f32(cp[8 * ks]), ah[0], al[0]);
    split<kEx>(to_f32(cp[8 * SB + 8 * ks]), ah[1], al[1]);
    split<kEx>(to_f32(cp[8 * ks + 4]), ah[2], al[2]);
    split<kEx>(to_f32(cp[8 * SB + 8 * ks + 4]), ah[3], al[3]);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      split<kEx>(to_f32(bp[16 * i * SB + 8 * ks]), bh[i][0], bl[i][0]);
      split<kEx>(to_f32(bp[16 * i * SB + 8 * ks + 4]), bh[i][1], bl[i][1]);
    }
    mma3<kEx, kEx>(s, ah, al, bh, bl);
  }
  // s[i][e] is row r0 + g + 8 (e >> 1), key k0 + 16i + 2t + (e & 1)
  float hq[2], lq[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    hq[r] = hi[r0 + g + 8 * r];
    lq[r] = lo[r0 + g + 8 * r];
  }
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const int k = k0 + 16 * i + 2 * t;
    const float2 hk = *reinterpret_cast<const float2*>(hi + k);
    const float2 lk = *reinterpret_cast<const float2*>(lo + k);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = r0 + g + 8 * r;
      const float v0 =
          k <= q && k < Q
              ? s[i][2 * r] * expf(diff2(hq[r], lq[r], hk.x, lk.x))
              : 0.f;
      const float v1 =
          k + 1 <= q && k + 1 < Q
              ? s[i][2 * r + 1] * expf(diff2(hq[r], lq[r], hk.y, lk.y))
              : 0.f;
      store_pair(Pr + (g + 8 * r) * sps + k - kb0, v0, v1);
    }
  }
}

// The G groups of scores (as above) in chunks of at most 4, each chunk
// one straight-line body: four bodies in all keep the kernel's code
// small (a body for each G, 1..8, made the kernel a third slower).
template <typename TB>
__device__ __forceinline__ void scores_any(int G, float* Pr, int sps,
                                           const TB* Cs, const TB* Bs,
                                           int SB, int nks, int r0, int k0,
                                           int kb0, const float* hi,
                                           const float* lo, int Q, int g,
                                           int t) {
  for (int i0 = 0; i0 < G; i0 += 4) {
    const int kc = k0 + 16 * i0;
    switch (min(4, G - i0)) {
      case 1:
        scores<1>(Pr, sps, Cs, Bs, SB, nks, r0, kc, kb0, hi, lo, Q, g, t);
        break;
      case 2:
        scores<2>(Pr, sps, Cs, Bs, SB, nks, r0, kc, kb0, hi, lo, Q, g, t);
        break;
      case 3:
        scores<3>(Pr, sps, Cs, Bs, SB, nks, r0, kc, kb0, hi, lo, Q, g, t);
        break;
      default:
        scores<4>(Pr, sps, Cs, Bs, SB, nks, r0, kc, kb0, hi, lo, Q, g, t);
    }
  }
}

// d[s][j] += a[s] * b[j] for the m-tiles s of a warp (slot 1 alone when
// MT = 1, slots 0 and 1 when MT = 2) and 4 n-tiles, 3xTF32 in rounds over
// all the accumulators, as mma3.
template <bool kExA, bool kExB, int MT>
__device__ __forceinline__ void mma3s(float (&d)[2][4][4],
                                      const uint32_t (&ah)[2][4],
                                      const uint32_t (&al)[2][4],
                                      const uint32_t (&bh)[4][2],
                                      const uint32_t (&bl)[4][2]) {
  if constexpr (!kExA) {
#pragma unroll
    for (int s = 2 - MT; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(d[s][j], al[s], bh[j]);
  }
  if constexpr (!kExB) {
#pragma unroll
    for (int s = 2 - MT; s < 2; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(d[s][j], ah[s], bl[j]);
  }
#pragma unroll
  for (int s = 2 - MT; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma(d[s][j], ah[s], bh[j]);
}

// acc[s] += C h^T for the query rows r[s] .. + 15 and the output columns
// pc .. pc + 31: M = query, K = n, N = p.  A (C) as in the scores; B (h):
// b0 = h[p g][n t], b1 = h[p g][n t+4].
template <int MT, typename TB>
__device__ __forceinline__ void c_ht(float (&acc)[2][4][4], const TB* Cs,
                                     int SB, const int (&r)[2],
                                     const float* Hs, int SH, int pc,
                                     int nks, int g, int t) {
  constexpr bool kEx = kIsBf16<TB>;
  const float* hp = Hs + (pc + g) * SH + t;
  for (int ks = 0; ks < nks; ++ks) {
    uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
    for (int s = 2 - MT; s < 2; ++s) {
      const TB* cp = Cs + (r[s] + g) * SB + 8 * ks + t;
      split<kEx>(to_f32(cp[0]), ah[s][0], al[s][0]);
      split<kEx>(to_f32(cp[8 * SB]), ah[s][1], al[s][1]);
      split<kEx>(to_f32(cp[4]), ah[s][2], al[s][2]);
      split<kEx>(to_f32(cp[8 * SB + 4]), ah[s][3], al[s][3]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split<false>(hp[8 * j * SH + 8 * ks], bh[j][0], bl[j][0]);
      split<false>(hp[8 * j * SH + 8 * ks + 4], bh[j][1], bl[j][1]);
    }
    mma3s<kEx, false, MT>(acc, ah, al, bh, bl);
  }
}

// acc[s] += Ps x over the 8-key group kk of the key block at K0, for the
// score rows pr[s] .. + 15 and the output columns pc .. pc + 31: M =
// query, K = key, N = p.  Keys renumbered in the group (k-index t is key
// 2t, t + 4 is key 2t + 1), so a lane's A values of a row are one 8-byte
// load, and B (x) reads rows 2t and 2t + 1: b0 = x[2t][p g], b1 =
// x[2t+1][p g].
template <int MT, typename TX>
__device__ __forceinline__ void ps_x(float (&acc)[2][4][4], const float* Ps,
                                     int sps, const int (&pr)[2], int kk,
                                     const TX* Xs, int SX, int K0, int pc,
                                     int g, int t) {
  constexpr bool kEx = kIsBf16<TX>;
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int s = 2 - MT; s < 2; ++s) {
    const float* pp = Ps + (pr[s] + g) * sps + 8 * kk + 2 * t;
    const float2 u0 = *reinterpret_cast<const float2*>(pp);
    const float2 u1 = *reinterpret_cast<const float2*>(pp + 8 * sps);
    split<false>(u0.x, ah[s][0], al[s][0]);
    split<false>(u1.x, ah[s][1], al[s][1]);
    split<false>(u0.y, ah[s][2], al[s][2]);
    split<false>(u1.y, ah[s][3], al[s][3]);
  }
  const TX* xp = Xs + (K0 + 8 * kk + 2 * t) * SX + pc + g;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    split<kEx>(to_f32(xp[8 * j]), bh[j][0], bl[j][0]);
    split<kEx>(to_f32(xp[SX + 8 * j]), bh[j][1], bl[j][1]);
  }
  mma3s<false, kEx, MT>(acc, ah, al, bh, bl);
}

template <typename TX, typename TA, typename TB>
__global__ void __launch_bounds__(kThreads, 1)
    ssd_kernel(const TX* __restrict__ x, const TA* __restrict__ a,
               const TB* __restrict__ bm, const TB* __restrict__ cm,
               const float* __restrict__ h0, TX* __restrict__ y,
               float* __restrict__ hout, int S, int H, int P, int N, int Q,
               int vx, int vbc, int vh, int vo, int ypair) {
  constexpr bool kExB = kIsBf16<TB>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(Q, P, N, sizeof(TX), sizeof(TB));
  const int SB = L.sb, SX = L.sx, SH = L.sh, SP = L.sp;
  const int Qp = L.qp, Pp = L.pp;
  TB* Bs = reinterpret_cast<TB*>(smem + L.b);
  TB* Cs = reinterpret_cast<TB*>(smem + L.c);
  TX* Xs = reinterpret_cast<TX*>(smem + L.x);
  float* Hs = reinterpret_cast<float*>(smem + L.h);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* hi = reinterpret_cast<float*>(smem + L.hi);
  float* lo = reinterpret_cast<float*>(smem + L.lo);
  float* wq = reinterpret_cast<float*>(smem + L.w);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t HP = (size_t)H * P;
  const size_t state = ((size_t)b * H + h) * P * N;
  const int nks = L.np / 8;  // k-steps over n
  // warp w: m-tiles a = w % 4 and 7 - a of each 128-row super-tile,
  // whose causal work together is the same for every w; output columns
  // 32 (w / 4) .. + 31 of each 64-column piece; the key groups of parity
  // w / 4 in the scores
  const int ma = warp & 3, mb = 7 - ma, half = warp >> 2;

  zero_pad(Bs, SB, Q, N, Qp, L.np, tid);
  zero_pad(Cs, SB, Q, N, Qp, L.np, tid);
  zero_pad(Xs, SX, Q, P, Qp, Pp, tid);
  zero_pad(Hs, SH, P, N, Pp, L.np, tid);

  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk is consumed, Hs written
    // the chunk in two groups: B and C, which the scores need first;
    // then x (and h0 with the first chunk)
    const size_t bc = ((size_t)b * S + c0) * N;
    copy_rows(Bs, SB, bm + bc, N, Q, N, vbc, tid);
    copy_rows(Cs, SB, cm + bc, N, Q, N, vbc, tid);
    cp_async_commit();
    copy_rows(Xs, SX, x + ((size_t)b * S + c0) * HP + (size_t)h * P, HP, Q,
              P, vx, tid);
    if (c0 == 0) copy_rows(Hs, SH, h0 + state, N, P, N, vh, tid);
    cp_async_commit();
    if (warp == 0) {  // inclusive cumsum of a over the chunk, in f64
      double carry = 0.0;
      for (int q0 = 0; q0 < Q; q0 += 128) {
        // lane l holds steps q0 + 4l .. + 3: its four loads in flight,
        // summed in order, then one scan over the lanes
        double v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + 4 * lane + i;
          v[i] = q < Q ? to_f32(a[((size_t)b * S + c0 + q) * H + h]) : 0.f;
        }
#pragma unroll
        for (int i = 1; i < 4; ++i) v[i] += v[i - 1];
        double run = v[3];
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(kFull, run, o);
          if (lane >= o) run += u;
        }
        const double base = carry + (run - v[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + 4 * lane + i;
          if (q < Q) {
            const double c = base + v[i];
            const float top = (float)c;
            hi[q] = top;
            lo[q] = (float)(c - top);
          }
        }
        carry += __shfl_sync(kFull, run, 31);
      }
      __syncwarp();
      const float hi_t = hi[Q - 1], lo_t = lo[Q - 1];
      for (int q = lane; q < Qp; q += 32) {
        const bool in = q < Q;
        wq[q] = in ? expf(diff2(hi_t, lo_t, hi[q], lo[q])) : 0.f;
        if (!in) hi[q] = lo[q] = 0.f;
      }
    }
    cp_async_wait<1>();
    __syncthreads();  // B, C, cum and w are in place

    // y = e^{cum} (C h^T) + Ps x, by super-tiles of 128 query rows, each
    // against key blocks of 128 up to its diagonal (one of each at Q <=
    // 128); the scores of a key block go to Ps, then every warp reads its
    // rows.  The first block's scores run while x and h land.
    bool first = true;
    for (int R0 = 0; R0 < Qp; R0 += kKB) {
      const int nm = min(8, (Qp - R0) / 16);
      // slot 1 holds the warp's longer m-tile (b, or a where b is past
      // the chunk), slot 0 the other (a), if any; -1: none
      const int m1 = mb < nm ? mb : (ma < nm ? ma : -1);
      const int m0 = mb < nm && ma < nm ? ma : -1;
      const int pr[2] = {16 * max(m0, 0), 16 * max(m1, 0)};
      const int rows[2] = {R0 + pr[0], R0 + pr[1]};
      const int kend = min(R0 + kKB, Qp);
      for (int p0 = 0; p0 < Pp; p0 += 64) {
        const int pc = p0 + 32 * half;
        float acc[2][4][4];
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[s][j][0] = acc[s][j][1] = acc[s][j][2] = acc[s][j][3] = 0.f;
        for (int K0 = 0; K0 < kend; K0 += kKB) {
          // 8-key groups of the block that each slot's rows see (even)
          const int n1 = m1 < 0 ? 0 : min(16, max(0, (rows[1] + 16 - K0) / 8));
          const int n0 = m0 < 0 ? 0 : min(16, max(0, (rows[0] + 16 - K0) / 8));
          if (p0 == 0 || R0 > 0) {  // else the scores in Ps are this block's
            if (!first) __syncthreads();  // the last scores are consumed
            if (n1)
              scores_any(n1 / 2, Ps + pr[1] * SP, SP, Cs, Bs, SB, nks,
                         rows[1], K0 + 8 * half, K0, hi, lo, Q, g, t);
            if (n0)
              scores_any(n0 / 2, Ps + pr[0] * SP, SP, Cs, Bs, SB, nks,
                         rows[0], K0 + 8 * half, K0, hi, lo, Q, g, t);
          }
          if (first) {
            cp_async_wait<0>();
            first = false;
          }
          __syncthreads();  // the scores are in Ps; x and h are in place
          if (K0 == 0) {  // e^{cum} (C h^T)
            if (m0 >= 0)
              c_ht<2>(acc, Cs, SB, rows, Hs, SH, pc, nks, g, t);
            else if (m1 >= 0)
              c_ht<1>(acc, Cs, SB, rows, Hs, SH, pc, nks, g, t);
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                const float e = expf(hi[rows[s] + g + 8 * r]);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  acc[s][j][2 * r] *= e;
                  acc[s][j][2 * r + 1] *= e;
                }
              }
          }
          // + Ps x: both slots over the groups both see, then slot 1
          for (int kk = 0; kk < n0; ++kk)
            ps_x<2>(acc, Ps, SP, pr, kk, Xs, SX, K0, pc, g, t);
          for (int kk = n0; kk < n1; ++kk)
            ps_x<1>(acc, Ps, SP, pr, kk, Xs, SX, K0, pc, g, t);
        }
        // acc[s][j][e]: row rows[s] + g + 8 (e >> 1), p = pc + 8j + 2t +
        // (e & 1)
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          if ((s ? m1 : m0) < 0) continue;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = rows[s] + g + 8 * r;
            if (q >= Q) continue;
            TX* yr = y + ((size_t)b * S + c0 + q) * HP + (size_t)h * P;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int p = pc + 8 * j + 2 * t;
              if (ypair && p + 1 < P) {
                store_pair(yr + p, acc[s][j][2 * r], acc[s][j][2 * r + 1]);
              } else {
                if (p < P) yr[p] = from_f32<TX>(acc[s][j][2 * r]);
                if (p + 1 < P)
                  yr[p + 1] = from_f32<TX>(acc[s][j][2 * r + 1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the old h is consumed

    // h <- e^{total} h + (x o w)^T B: M = p, K = q, N = n, in pieces of
    // 16 p by 32 n, the accumulators started from e^{total} h.  q
    // renumbered in each group of 8 as the keys above: A (x o w) reads
    // rows 2t and 2t + 1 of x, B (B) b0 = B[2t][n g], b1 = B[2t+1][n g]
    const float et = expf(hi[Q - 1]);
    const int pmt = Pp / 16;
    for (int pc = warp; pc < pmt * (L.np / 32); pc += kWarps) {
      const int p0 = 16 * (pc % pmt), n0 = 32 * (pc / pmt);
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 v = *reinterpret_cast<const float2*>(
              Hs + (p0 + g + 8 * r) * SH + n0 + 8 * j + 2 * t);
          acc[j][2 * r] = et * v.x;
          acc[j][2 * r + 1] = et * v.y;
        }
      const TX* xp = Xs + 2 * t * SX + p0 + g;
      const TB* bp = Bs + 2 * t * SB + n0 + g;
      for (int kq = 0; kq < Qp / 8; ++kq) {
        const float2 w = *reinterpret_cast<const float2*>(wq + 8 * kq + 2 * t);
        const TX* xq = xp + 8 * kq * SX;
        uint32_t ah[4], al[4], bh[4][2], bl[4][2];
        split<false>(to_f32(xq[0]) * w.x, ah[0], al[0]);
        split<false>(to_f32(xq[8]) * w.x, ah[1], al[1]);
        split<false>(to_f32(xq[SX]) * w.y, ah[2], al[2]);
        split<false>(to_f32(xq[SX + 8]) * w.y, ah[3], al[3]);
        const TB* bq = bp + 8 * kq * SB;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split<kExB>(to_f32(bq[8 * j]), bh[j][0], bl[j][0]);
          split<kExB>(to_f32(bq[SB + 8 * j]), bh[j][1], bl[j][1]);
        }
        mma3<false, kExB>(acc, ah, al, bh, bl);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          store_pair(Hs + (p0 + g + 8 * r) * SH + n0 + 8 * j + 2 * t,
                     acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
  __syncthreads();
  store_rows(hout + state, N, Hs, SH, P, N, vo, tid);
}

// the widest piece, 16, 8 or 4 bytes, in which rows of `row_bytes` bytes
// starting at `ptr` (and `ld_bytes` apart) can be copied; 0 if none
int piece_bytes(const void* ptr, size_t row_bytes, size_t ld_bytes) {
  const size_t all = reinterpret_cast<uintptr_t>(ptr) | row_bytes | ld_bytes;
  for (int v = 16; v >= 4; v /= 2)
    if (all % v == 0) return v;
  return 0;
}

template <typename TX, typename TA, typename TB>
int launch_typed(const void* x, const void* a, const void* bm,
                 const void* cm, const float* h0, void* y, float* hout,
                 int B, int S, int H, int P, int N, int Q,
                 cudaStream_t stream) {
  const size_t smem = Layout(Q, P, N, sizeof(TX), sizeof(TB)).bytes;
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<TX, TA, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  const size_t xrow = sizeof(TX) * P, brow = sizeof(TB) * N;
  const int vx = piece_bytes(x, xrow, xrow * H);
  const int vb = piece_bytes(bm, brow, brow), vc = piece_bytes(cm, brow, brow);
  const int vbc = vb < vc ? vb : vc;
  const int vh = piece_bytes(h0, 4 * (size_t)N, 4 * (size_t)N);
  const int vo = piece_bytes(hout, 4 * (size_t)N, 4 * (size_t)N);
  const int ypair =
      P % 2 == 0 && reinterpret_cast<uintptr_t>(y) % (2 * sizeof(TX)) == 0;
  const dim3 grid(H, B);
  ssd_kernel<TX, TA, TB><<<grid, kThreads, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TA*>(a),
      static_cast<const TB*>(bm), static_cast<const TB*>(cm), h0,
      static_cast<TX*>(y), hout, S, H, P, N, Q, vx, vbc, vh, vo, ypair);
  return (int)cudaGetLastError();
}

template <typename TX, typename TA>
int launch_bc(const void* x, const void* a, const void* bm, const void* cm,
              const float* h0, void* y, float* hout, int B, int S, int H,
              int P, int N, int Q, int bc_dtype, cudaStream_t stream) {
  if (bc_dtype == 0)
    return launch_typed<TX, TA, float>(x, a, bm, cm, h0, y, hout, B, S, H,
                                       P, N, Q, stream);
  if (bc_dtype == 1)
    return launch_typed<TX, TA, __nv_bfloat16>(x, a, bm, cm, h0, y, hout, B,
                                               S, H, P, N, Q, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TX>
int launch_a(const void* x, const void* a, const void* bm, const void* cm,
             const float* h0, void* y, float* hout, int B, int S, int H,
             int P, int N, int Q, int a_dtype, int bc_dtype,
             cudaStream_t stream) {
  if (a_dtype == 0)
    return launch_bc<TX, float>(x, a, bm, cm, h0, y, hout, B, S, H, P, N, Q,
                                bc_dtype, stream);
  if (a_dtype == 1)
    return launch_bc<TX, __nv_bfloat16>(x, a, bm, cm, h0, y, hout, B, S, H,
                                        P, N, Q, bc_dtype, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: (B,S,H,P); a: (B,S,H); bm, cm: (B,S,N); h0, hout: (B,H,P,N)
// float32; all contiguous.  1 <= Q, S % Q == 0.  dtype codes: 0 =
// float32, 1 = bfloat16, for x (and y), a, and bm/cm separately.
extern "C" int ssd_scan_launch(const void* x, const void* a, const void* bm,
                               const void* cm, const void* h0, void* y,
                               void* hout, int B, int S, int H, int P, int N,
                               int Q, int x_dtype, int a_dtype, int bc_dtype,
                               void* stream) {
  if (Q < 1 || S % Q != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* houtf = static_cast<float*>(hout);
  if (x_dtype == 0)
    return launch_a<float>(x, a, bm, cm, h0f, y, houtf, B, S, H, P, N, Q,
                           a_dtype, bc_dtype, s);
  if (x_dtype == 1)
    return launch_a<__nv_bfloat16>(x, a, bm, cm, h0f, y, houtf, B, S, H, P,
                                   N, Q, a_dtype, bc_dtype, s);
  return (int)cudaErrorInvalidValue;
}
