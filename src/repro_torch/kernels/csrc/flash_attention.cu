// Forward flash attention (GQA, causal with sequence ends aligned,
// optional sliding window), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _kernel): q (B,Sq,H,D) against k, v
// (B,Skv,KV,D), query head h reading KV head h / G (G = H/KV); query i
// sits at key position q_offset + i (the Pallas kernel's Skv - Sq, ends
// aligned, unless the caller asks for continuation attention, where any
// q_offset >= 0 and Sq > Skv are allowed); keys after a query (causal) or
// window or more positions before it are masked; online softmax with
// f32 running max m, sum l and accumulator; output acc / max(l, 1e-30)
// in q's type.  On the serving path it runs once per layer per prefill:
// 22 per TinyLlama prefill at q (B,S,32,64), k/v (B,S,4,64), and 9 per
// Zamba2 prefill (its shared attention block) at q, k, v (B,S,32,80),
// float32, S = 128 (32 when calibrating).
//
// What bounds it.  Per unmasked (query, key) pair, 2*D operations for
// QK^T and 2*D for PV; causal leaves S*(S+1)/2 pairs per head.  The
// kernel keeps f32 precision on the tensor cores with 3xTF32 (three
// TF32 products per f32 product, below), so the least time is
// max(bytes / 3.35 TB/s, 3 * operations / 495 TFLOP/s TF32).  At B=8,
// S=128, H=32: D = 64 moves 18.9 MB (q, o, k, v: 5.63 us) against
// 3 * 541 MFLOP (3.28 us); D = 80 moves 41.9 MB (12.52 us) against
// 3 * 676 MFLOP (4.10 us).  Both are bound by bytes, and both fit in
// the 50 MB L2, where the serving path (and the timing) finds them.
//
// Design.
// - Tensor cores at f32 precision: mma.sync m16n8k8 TF32 with f32
//   accumulation for QK^T and for PV.  Each f32 operand x is split into
//   hi = rna(x) and lo = rna(x - hi), rna being cvt.rna.tf32.f32's
//   rounding (to nearest, ties away), and a product is lo*hi + hi*lo +
//   hi*hi, small terms first (3xTF32): the pair carries 22 of x's 24
//   bits, and the dropped lo*lo is below f32's rounding.  A raw f32
//   operand would be truncated by the tensor core, so lo is rounded
//   explicitly too.  Plain TF32 (hi*hi alone) misses the reference's
//   2e-5 by 20-80x (tests/test_torch_flash_attention.py emulates both).
//   rna is two integer operations (add 0x1000, clear the low 13 bits),
//   cheaper on the card than the cvt instruction.  bf16 values are
//   exact in TF32 (lo = 0): a bf16 call takes hi*hi for QK^T and two
//   products for PV (P is f32).
// - The products are the kernel's instruction stream, so everything is
//   arranged for them.  The three rounds of a 3xTF32 product go to
//   different accumulators in turn (the 8 of S, or 8-10 of PV, before
//   the next round), so no product waits on the one before it; and each
//   tile's work is one block of straight-line code (a run-time test
//   around each 8-key group would make every product wait on the last).
// - FA2 layout in registers.  Each warp owns two m-tiles of 16 query
//   rows (one at D = 128, where two do not fit in 255 registers) and
//   keeps their scores S (16 x 32 keys each), running m and l, and
//   16 x D outputs in registers; row max and row sum reduce over the
//   4 lanes of a quad (2 shuffles), and l stays a per-lane partial sum
//   until the end.  P never goes to shared memory: the accumulator
//   layout of S gives lane (g = lane/4, t = lane%4) keys 2t and 2t+1 of
//   each group of 8, rows g and g+8, and the A operand of PV wants
//   k-indices t and t+4.  Renumbering the keys of a group (key 2t is
//   k-index t, key 2t+1 is t+4) makes S's registers PV's A fragment as
//   they are, and V's B fragment reads the same rows: b0 = V[2t][g],
//   b1 = V[2t+1][g].  The d axis of QK^T is renumbered the same way
//   (d = 2t, 2t+1 of each group of 8 are k-indices t, t+4), so a lane
//   reads its two values of a q or k row as one 8-byte (f32) or 4-byte
//   (bf16) load.  Two m-tiles a warp split each k and v fragment once
//   for 32 rows instead of 16: the splits, not the products, are most
//   of the instructions.
// - A block of 4 warps owns 128 query rows of one (b, h) (64 at
//   D = 128); warp w holds m-tiles w and 7 - w, one near each end of the
//   diagonal, so the warps' causal work is equal (5 steps of an m-tile
//   by 32 keys each at S = 128) and the pairs computed are 1.24x the
//   causal ones.  A key
//   tile is skipped by an m-tile whose rows see none of it (past its
//   diagonal or before its window), and masked only where it straddles
//   the diagonal, the window's edge or Skv.  The grid is (H, B, q-tiles)
//   with the last q-tile first (blockIdx.z reversed); at the path's
//   S = 128 and B = 8 that is 256 blocks, one wave at 2 blocks an SM,
//   and the 8 heads of a TinyLlama KV head run side by side.
// - A two-stage ring of 32-key K/V tiles in shared memory, in the
//   input's type, filled by 16-byte cp.async: the next tile's copy is
//   issued right after the block's one barrier per tile and lands while
//   this tile's products run.  Rows past Skv (and q rows past Sq) are
//   zero-filled (src-size 0), never read.  Row strides (q and k: D + 8
//   elements; v: D + 16 bytes) keep rows 16-byte aligned and every
//   fragment load free of bank conflicts at all four head sizes.  At
//   D = 80 in f32 the ring is 43 KB and q 44 KB: 2 blocks an SM, as the
//   registers also allow (225 a thread; no instantiation spills).
// - Masked entries get p = 0 explicitly: a masked score is -inf, a row
//   whose running max is still -inf subtracts 0 instead, and exp2 of
//   -inf is 0.  So a row that meets a tile in which all its keys are
//   masked (a window starting mid-tile, a ragged Sq tail) keeps l = 0
//   and acc = 0 until a valid key arrives, and the result equals the
//   reference's finite -1e30 softmax, whose masked terms are exp(-1e30
//   - max) = 0 in f32.  Scores are scaled by scale * log2(e) and
//   exponentiated with ex2.approx.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/time_attention.py,
// PERF.md): 24.7-25.1 us a call at Zamba2's B = 8 prefill (D =
// 80; the SIMT kernel this replaces 73.0-73.9, SDPA 52.3-53.4), 2.0x
// the bound; 19.3-19.5 us at TinyLlama's (D = 64; 45.8-46.3, SDPA
// 126-133), 3.4x the bound.  f32 error against the plain version at
// every path shape <= 4.8e-6.
//
// What a later design would change: wgmma from shared memory (the
// card's full TF32 rate; here the stream of splits and products stalls
// on its own latencies with 2 warps a scheduler) with K/V brought in by
// a TMA producer warp into a deeper ring, the splits done once per tile
// by the producer side; and at TinyLlama's D = 64 all G = 8 query heads
// of a KV head in one block, so K and V are read and split once per
// group instead of once per head.
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, the kernel is launched on that stream,
// and the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;                 // keys per tile
constexpr int kNJ = kBK / 8;            // 8-key groups (n-tiles of S)
constexpr int kMinBlocks = 2;           // blocks an SM, __launch_bounds__
constexpr unsigned kFull = 0xffffffffu;

// The block of one (T, D): m-tiles of 16 query rows a warp (two, or one
// at D = 128, where two would not fit in registers), and its shared
// memory: a two-stage ring of k and v tiles, then the block's q rows.
template <typename T, int D>
struct Smem {
  static constexpr int kMT = D > 80 ? 1 : 2;
  static constexpr int kBQ = 16 * kMT * kWarps;   // query rows a block
  static constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kVec = 16 / sizeof(T);   // elements per chunk
  static constexpr int kChunks = D / kVec;      // 16-byte chunks per row
  static constexpr int kKS = D + 8;             // q and k row stride
  static constexpr int kVS = D + kVec;          // v row stride
  static constexpr int kStage = kBK * (kKS + kVS);
  static constexpr int kQOff = 2 * kStage;
  static constexpr size_t kBytes = sizeof(T) * (2 * kStage + kBQ * kKS);
  static_assert(D % 16 == 0, "head sizes are multiples of 16");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Two neighbouring elements of shared memory as f32.
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a,
                                           float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

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

// 16 bytes global -> shared, asynchronous; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Rows [r0, r0 + ROWS) of a matrix whose rows are `ld` elements apart, D
// wide, into shared rows of SS elements; rows >= n are zero-filled.
template <typename T, int D, int SS, int ROWS>
__device__ __forceinline__ void load_tile(T* s, const T* g, size_t ld,
                                          int r0, int n, int tid) {
  constexpr int kVec = 16 / sizeof(T), kChunks = D / kVec;
  constexpr int kAll = ROWS * kChunks;
#pragma unroll
  for (int i = 0; i < (kAll + kThreads - 1) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    if (kAll % kThreads && e >= kAll) break;
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r0 + r < n;
    cp_async16(s + r * SS + c * kVec,
               g + (size_t)(in ? r0 + r : 0) * ld + c * kVec, in);
  }
}

// 2^x in one MUFU.EX2 (about 2 ulp; results below 2^-126 flush to 0,
// and 2^-inf is 0).  exp2f adds a range fix-up of four instructions.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// What a warp carries across the key tiles for its MT m-tiles: the
// output accumulator (n-tile n: row g at [0], [1], row g+8 at [2], [3],
// columns 8n + 2t, +1), and the running max m and partial sum l of rows
// g and g+8.
template <int MT, int D>
struct Rows {
  float acc[MT][D / 8][4];
  float m[MT][2], l[MT][2];
};

// One key tile for one warp: its m-tiles 0 and 1 where A0 and A1 are set
// (constants, so each case is straight-line code whose independent
// products the scheduler can interleave; the k and v fragments are
// split once for both).  Qs: the block's q rows in shared memory; mrow:
// each m-tile's first row in the block; qpos: key position of each
// m-tile's row g; masked: some entry of the m-tile is past the
// diagonal, outside the window or past Skv.
template <typename T, int D, bool A0, bool A1, int MT = Smem<T, D>::kMT>
__device__ __forceinline__ void attend(Rows<MT, D>& w, const T* Qs,
                                       const int (&mrow)[MT], const T* Ks,
                                       const T* Vs, int g, int t,
                                       const bool (&masked)[MT], int k0,
                                       const int (&qpos)[MT], int Skv,
                                       int causal, int window,
                                       float scale_log2) {
  using L = Smem<T, D>;
  constexpr int kMT = MT;
  constexpr bool kExact = L::kExact;
  constexpr int kKSteps = D / 8;   // k-steps of QK^T, n-tiles of PV
  constexpr int kNC = kKSteps % 4 ? 5 : 4;   // PV n-tiles a round
  auto on = [](int mt) { return mt ? A1 : A0; };

  // S = Q K^T.  A (q): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8,
  // t+4), k-index t being d = 8ks + 2t and t+4 being d = 8ks + 2t + 1;
  // B (k): b0 (k t, key g) = K[8j + g][8ks + 2t], b1 the next d.
  float s[kMT][kNJ][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll 2
  for (int ks = 0; ks < kKSteps; ++ks) {
    uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (!on(mt)) continue;
      const T* qp = Qs + (mrow[mt] + g) * L::kKS + 8 * ks + 2 * t;
      const float2 x0 = pair_f32(qp), x1 = pair_f32(qp + 8 * L::kKS);
      split<kExact>(x0.x, ah[mt][0], al[mt][0]);
      split<kExact>(x1.x, ah[mt][1], al[mt][1]);
      split<kExact>(x0.y, ah[mt][2], al[mt][2]);
      split<kExact>(x1.y, ah[mt][3], al[mt][3]);
    }
    uint32_t bh[kNJ][2], bl[kNJ][2];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const float2 kx =
          pair_f32(Ks + (8 * j + g) * L::kKS + 8 * ks + 2 * t);
      split<kExact>(kx.x, bh[j][0], bl[j][0]);
      split<kExact>(kx.y, bh[j][1], bl[j][1]);
    }
    // 3xTF32 in rounds, lo*hi, hi*lo, hi*hi (small terms first), so
    // consecutive products feed different accumulators
    if constexpr (!kExact) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          if (on(mt)) mma(s[mt][j], al[mt], bh[j]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < kNJ; ++j)
          if (on(mt)) mma(s[mt][j], ah[mt], bl[j]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        if (on(mt)) mma(s[mt][j], ah[mt], bh[j]);
  }

  // s[mt][j][e] is row g + 8 (e >> 1) of m-tile mt, key
  // k0 + 8j + 2t + (e & 1)
  float base[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    if (!on(mt)) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[mt][j][e] *= scale_log2;
    if (masked[mt]) {
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = qpos[mt] + 8 * (e >> 1);
          bool ok = kpos < Skv;
          if (causal) ok = ok && kpos <= qp;
          if (window) ok = ok && qp - kpos < window;
          if (!ok) s[mt][j][e] = -INFINITY;
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = w.m[mt][r];
#pragma unroll
      for (int j = 0; j < kNJ; ++j)
        mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
      mx = quad_max(mx);
      base[mt][r] = mx == -INFINITY ? 0.f : mx;  // no valid key yet: p = 0
      const float alpha = exp2_fast(w.m[mt][r] - base[mt][r]);
      w.m[mt][r] = mx;
      w.l[mt][r] *= alpha;
#pragma unroll
      for (int n = 0; n < kKSteps; ++n) {
        w.acc[mt][n][2 * r] *= alpha;
        w.acc[mt][n][2 * r + 1] *= alpha;
      }
    }
  }

  // P V: P's registers are the A fragment as they stand (key 2t is
  // k-index t, key 2t+1 is t+4); V's B fragment reads those rows:
  // b0 = V[8j + 2t][8n + g], b1 = V[8j + 2t + 1][8n + g]
#pragma unroll
  for (int j = 0; j < kNJ; ++j) {
    uint32_t ph[kMT][4], pl[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (!on(mt)) continue;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_fast(s[mt][j][e] - base[mt][e >> 1]);
        w.l[mt][e >> 1] += p[e];
      }
      split<false>(p[0], ph[mt][0], pl[mt][0]);   // (g, t)
      split<false>(p[2], ph[mt][1], pl[mt][1]);   // (g+8, t)
      split<false>(p[1], ph[mt][2], pl[mt][2]);   // (g, t+4)
      split<false>(p[3], ph[mt][3], pl[mt][3]);   // (g+8, t+4)
    }
    const T* v0 = Vs + (8 * j + 2 * t) * L::kVS + g;
#pragma unroll
    for (int n0 = 0; n0 < kKSteps; n0 += kNC) {
      uint32_t bh[kNC][2], bl[kNC][2];
#pragma unroll
      for (int c = 0; c < kNC; ++c) {
        split<kExact>(to_f32(v0[8 * (n0 + c)]), bh[c][0], bl[c][0]);
        split<kExact>(to_f32(v0[L::kVS + 8 * (n0 + c)]), bh[c][1],
                      bl[c][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          if (on(mt)) mma(w.acc[mt][n0 + c], pl[mt], bh[c]);
      if constexpr (!kExact) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int c = 0; c < kNC; ++c)
            if (on(mt)) mma(w.acc[mt][n0 + c], ph[mt], bl[c]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int c = 0; c < kNC; ++c)
          if (on(mt)) mma(w.acc[mt][n0 + c], ph[mt], bh[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int H, int KV, int causal, int window,
                     int q_offset, float scale_log2) {
  using L = Smem<T, D>;
  constexpr int kMT = L::kMT, kBQ = L::kBQ, kKSteps = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* Qs = ring + L::kQOff;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // last tile first
  const int kvh = h / (H / KV);
  const size_t q_ld = (size_t)H * D, kv_ld = (size_t)KV * D;
  const T* qb = q + (size_t)b * Sq * q_ld + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_ld + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Skv * kv_ld + (size_t)kvh * D;

  // keys any row of the block can see: [k_lo, k_hi), in whole tiles
  const int k_lo = window ? max(0, q_offset + q0 - window + 1) : 0;
  const int k_hi = causal ? min(Skv, q_offset + min(q0 + kBQ, Sq)) : Skv;
  const int t_first = k_lo / kBK;
  const int n_tiles = (k_hi + kBK - 1) / kBK - t_first;

  // the warp's m-tiles: rows 16 w and (with two) 16 (7 - w) of the
  // block, one near each end of the diagonal, so that each warp's causal
  // work is about the same.  An m-tile's rows sit at key positions
  // [first, last] and see keys in [lo, hi); an m-tile past Sq computes
  // nothing.
  int mrow[kMT], first[kMT], last[kMT], qpos[kMT];
  bool rows[kMT];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    mrow[mt] = 16 * (mt ? 2 * kWarps - 1 - warp : warp);
    const int r0 = q0 + mrow[mt];
    rows[mt] = r0 < Sq;
    first[mt] = q_offset + r0;
    last[mt] = q_offset + min(r0 + 16, Sq) - 1;
    qpos[mt] = first[mt] + g;
  }

  load_tile<T, D, L::kKS, kBQ>(Qs, qb, q_ld, q0, Sq, tid);
  load_tile<T, D, L::kKS, kBK>(ring, kb, kv_ld, t_first * kBK, Skv, tid);
  load_tile<T, D, L::kVS, kBK>(ring + kBK * L::kKS, vb, kv_ld,
                               t_first * kBK, Skv, tid);
  cp_async_commit();

  Rows<kMT, D> w;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int n = 0; n < kKSteps; ++n)
      w.acc[mt][n][0] = w.acc[mt][n][1] = w.acc[mt][n][2] =
          w.acc[mt][n][3] = 0.f;
    w.m[mt][0] = w.m[mt][1] = -INFINITY;
    w.l[mt][0] = w.l[mt][1] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    // tile `it` (and q) has landed, and every warp is done with tile
    // it - 1, so its stage takes tile it + 1
    cp_async_wait_all();
    __syncthreads();
    const int k0 = (t_first + it) * kBK;
    if (it + 1 < n_tiles) {
      T* next = ring + ((it + 1) & 1) * L::kStage;
      load_tile<T, D, L::kKS, kBK>(next, kb, kv_ld, k0 + kBK, Skv, tid);
      load_tile<T, D, L::kVS, kBK>(next + kBK * L::kKS, vb, kv_ld,
                                   k0 + kBK, Skv, tid);
      cp_async_commit();
    }
    // an m-tile whose rows see no key of the tile skips it
    bool use[kMT], masked[kMT];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int hi = causal ? min(Skv, last[mt] + 1) : Skv;
      use[mt] = rows[mt] && hi > k0 &&
                !(window && first[mt] - window + 1 >= k0 + kBK);
      masked[mt] = (causal && k0 + kBK - 1 > first[mt]) ||
                   (window && k0 <= last[mt] - window) || k0 + kBK > Skv;
    }
    const T* Ks = ring + (it & 1) * L::kStage;
    const T* Vs = Ks + kBK * L::kKS;
    if constexpr (kMT == 1) {
      if (use[0])
        attend<T, D, true, false>(w, Qs, mrow, Ks, Vs, g, t, masked, k0,
                                  qpos, Skv, causal, window, scale_log2);
    } else if (use[0] && use[1]) {
      attend<T, D, true, true>(w, Qs, mrow, Ks, Vs, g, t, masked, k0, qpos,
                               Skv, causal, window, scale_log2);
    } else if (use[0]) {
      attend<T, D, true, false>(w, Qs, mrow, Ks, Vs, g, t, masked, k0,
                                qpos, Skv, causal, window, scale_log2);
    } else if (use[1]) {
      attend<T, D, false, true>(w, Qs, mrow, Ks, Vs, g, t, masked, k0,
                                qpos, Skv, causal, window, scale_log2);
    }
  }

  T* ob = o + (size_t)b * Sq * q_ld + (size_t)h * D + 2 * t;
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const float l0 = quad_sum(w.l[mt][0]), l1 = quad_sum(w.l[mt][1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + mrow[mt] + g + 8 * r;
      if (row >= Sq) continue;
      const float inv = 1.f / fmaxf(r ? l1 : l0, 1e-30f);
      T* orow = ob + (size_t)row * q_ld;
#pragma unroll
      for (int n = 0; n < kKSteps; ++n)
        store_pair(orow + 8 * n, w.acc[mt][n][2 * r] * inv,
                   w.acc[mt][n][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Skv, int H, int KV, int causal,
                 int window, int q_offset, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D>::kBytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          flash_fwd_kernel<T, D>,
          cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int q_tiles = (Sq + Smem<T, D>::kBQ - 1) / Smem<T, D>::kBQ;
  if (B > 65535 || q_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(H, B, q_tiles);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, causal,
      window, q_offset, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int B,
               int Sq, int Skv, int H, int KV, int D, int causal, int window,
               int q_offset, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_typed<T, 32>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                 window, q_offset, scale, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                 window, q_offset, scale, stream);
    case 80:
      return launch_typed<T, 80>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                 window, q_offset, scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, B, Sq, Skv, H, KV, causal,
                                  window, q_offset, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B,Sq,H,D); k, v: (B,Skv,KV,D); all contiguous, 16-byte aligned,
// one type (dtype 0 = float32, 1 = bfloat16).  q_offset >= 0: key
// position of query 0 (Skv - Sq for ends aligned).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int KV, int D,
                                      int causal, int window, int q_offset,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k, v, o, B, Sq, Skv, H, KV, D, causal,
                             window, q_offset, scale, s);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, o, B, Sq, Skv, H, KV, D,
                                     causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
