// Flash-decode: one query token per sequence against a KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas, body _kernel): q (B,1,H,D) against caches
// (B,S,KV,D) with cur_len (B,) valid entries per row; positions
// >= cur_len, and with a window those < cur_len - window, are masked
// with the reference's finite -1e30; cache tiles with no valid position
// are skipped and read nothing; online softmax with f32 m, l, acc and p
// kept in f32 for the PV product; output acc / max(l, 1e-30) in q's
// type.  q and the cache may differ in type: the serving path's default
// is f32 q over a bf16 cache.  22 calls per TinyLlama decode step, q
// (B,1,32,64) over caches (B,512,4,64), G = H/KV = 8; 9 per Zamba2
// step, q (B,1,32,80) over (B,512,32,80), G = 1; granite-34b's
// multi-query attention, q (B,1,48,128) over (B,512,1,128), G = 48.
// Like the Pallas kernel, which holds a group as one (G, D) tile, it
// takes any G that divides H.
//
// What bounds it.  Each valid cache row (k and v, D values each) is
// read once for the G query heads of its group: 4*G*D operations
// against 4*D bytes (bf16), ~8 operations per byte at G = 8 and ~1 at
// G = 1, under the card's ~20 f32 operations per byte: memory-bound.
// At the path's sizes the valid cache is 1-2 MB, L2-resident when warm,
// so what is left is latency: how long the longest chain of dependent
// loads and barriers is, and how many of them run at once.  The Pallas
// grid (B, KV, S/bs) runs the sequence axis in order with m, l, acc in
// VMEM; one block per (b, kv head) walking its cache in order (the
// first port of this kernel) gave 32 blocks on 132 SMs at TinyLlama's
// B = 8, 4 at B = 1, and at G = 1 one busy warp in eight.
//
// Design.
// - Split-K over the valid range, decided on the device.  The grid is
//   (splits, KV, B) (KV * ceil(G/64) on y when G > 64, below).  Each
//   block reads cur_len[b] itself, computes the
//   valid range [lo, hi), and takes an equal share of the 64-row tiles
//   that overlap it (shares differ by at most one tile), so every tile
//   a block touches holds a valid position.  `splits` depends on
//   shapes only (the wrapper's num_splits: a few blocks per SM, at most
//   ceil(S/64)); the host never reads cur_len, so the serving path
//   stays free of syncs and can be captured in a CUDA graph.
// - Every warp busy at every G.  The 8 warps are HS head slices times
//   8/HS position slices, HS = 1, 2, 4, 8 for G <= 8, 16, 32, 64: a
//   warp holds at most 8 heads and PW = 8*HS positions of each tile,
//   taken PL = min(PW, 32) at a time (HS = 8: one head slice a warp,
//   each warp walks the whole tile in two passes of 32 positions, a
//   lane one position a pass).  For the scores R = 32/PL lanes share a
//   position, each summing a part of the D products, joined by
//   shuffles; for the PV product lane l holds output columns l + 32 j
//   (ceil(D/32) of them), p broadcast by shuffle.  Each warp runs its
//   own online softmax over its positions; at the end the block merges
//   its warps' (m, l, acc) in shared memory.  Every block reads its
//   tiles of the cache once for all the heads it holds: granite's one
//   KV head is read once per (b, split) for its 48 query heads.
//   The heads a warp may hold (HM: G rounded up to a power of two, at
//   most 8) are a template parameter, so a lane keeps HM * ceil(D/32)
//   accumulators and no more: at G = 1 the kernel needs few registers
//   and more blocks fit on an SM.  q's type is a flag, not a template
//   parameter, to keep the number of instantiations (and the build) down.
// - G > 64: the grid's y axis is KV * ceil(G/64), each block holding 64
//   heads of its group (the last one the rest).  A block cannot hold
//   the registers of more than 64 heads, so a loop over head chunks
//   inside the block would read each tile once per chunk too; as
//   blocks the chunks run side by side, and a chunk's read of a tile
//   may find it in L2 after another's.  No config of the repo has
//   G > 48; the card tests run G = 96.
// - 16-byte cp.async loads, neighbouring lanes on neighbouring 16-byte
//   chunks of a row, into a two-stage ring of tiles in the cache's own
//   type (tile i+1 in flight while tile i is used); rows outside
//   [lo, hi) are zero-filled, not read.  Values are converted to f32
//   when read.  k rows are stored at an odd stride of 16-byte chunks,
//   so the 8 lanes of each quarter-warp read 8 rows on 8 distinct bank
//   groups: the score loop has no bank conflicts.
// - Partials and a combine pass.  Each split writes, per head, its
//   unnormalised acc (D) and its m and l (f32) to a scratch buffer that
//   the wrapper allocates; a second kernel, launched right after on the
//   same stream, merges the splits per (b, head) and writes
//   acc / max(l, 1e-30) in q's type.
// - The finite -1e30 mask: a masked position gets p = 0 explicitly,
//   never exp(-1e30 - m), so a warp or split whose positions are all
//   masked contributes l = 0, acc = 0 (a split with no valid tile reads
//   no cache at all), and a row with cur_len = 0 gives 0.
//
// The block entry (decode_attention_block_launch) runs the same two
// passes over one block of a cache split along its sequence axis (a
// sequence-sharded cache, one block a rank): the block's rows sit at
// global positions [offset, offset + S), cur_len and the window stay
// global, and an optional lo_len (B,) raises each row's first valid
// position (the slice-reads window).  A split kernel's block reads only
// the tiles of its rows that are valid in the whole cache.  The combine
// writes the block's o in f32 and lse = m + log(l); the caller merges
// blocks by log-sum-exp (models/layers.py).  A block with no valid row
// gives o = 0 and lse = -inf.
//
// Measured at G = 48 on one KV head (granite, B = 8, cache 512; NVIDIA
// H100 80GB HBM3, 700 W; chip_smoke.py, PERF.md): 24.1 us a call against
// SDPA's 13.0 and a 0.44 us bound.  At B = 8 the grid holds 64 blocks for
// 132 SMs, each walking its tiles for 48 heads: latency-bound, left for a
// PR that makes the kernel faster.
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, both kernels are launched on that
// stream, and the function returns cudaGetLastError() so the caller can
// raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 64;        // cache positions per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockHeads = 64;  // heads a block holds: 8 slices of 8
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory layout of one stage of the ring for cache type TC:
// kBS k rows at an odd stride of 16-byte chunks, then kBS v rows.
template <typename TC, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(TC);   // elements per chunk
  static constexpr int kChunks = D / kVec;       // chunks per row
  static constexpr int kKStride = kChunks | 1;   // k row stride, chunks
  static constexpr int kStage = kBS * (kKStride + kChunks) * kVec;
  static constexpr size_t kRingBytes = 2 * kStage * sizeof(TC);
  static_assert(D % kVec == 0, "a row must be whole 16-byte chunks");
};

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

// One 16-byte chunk of shared memory to f32.
__device__ __forceinline__ void chunk_f32(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void chunk_f32(const __nv_bfloat16* p,
                                          float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Scratch row of (b, head, split): acc[0..D), then m, then l.
template <int D>
__device__ __forceinline__ float* part_row(float* part, int bh, int split,
                                           int splits) {
  return part + ((size_t)bh * splits + split) * (D + 2);
}

// HS head slices of the block's warps, each of at most HM heads (HM a
// power of two, so a warp holds registers for the heads it can have and
// no more); q is f32 (q_bf16 = 0) or bf16, read once into shared memory.
// Registers are budgeted for 4 blocks an SM with one head a warp, or two
// over a bf16 cache (G = 1 is Zamba2's: its 512 blocks at B = 8 then
// run in one wave), and for 2 blocks with more heads over a bf16 cache;
// beyond one head an f32 cache's wider chunks get the compiler's full
// budget, so no instantiation spills.
template <typename TC, int D, int HS, int HM>
__global__ void __launch_bounds__(
    kThreads, (HM == 1 || (HM == 2 && sizeof(TC) == 2)) ? 4
              : sizeof(TC) == 2                         ? 2
                                                        : 1)
    decode_split_kernel(const void* __restrict__ q, int q_bf16,
                        const TC* __restrict__ kc, const TC* __restrict__ vc,
                        const int* __restrict__ cur_len,
                        const int* __restrict__ lo_len,
                        float* __restrict__ part, int S, int H, int KV,
                        int window, int offset, float scale, int splits) {
  using T = Tile<TC, D>;
  constexpr int VEC = T::kVec, NC = T::kChunks, KST = T::kKStride;
  constexpr int PS = kWarps / HS;  // position slices
  constexpr int PW = kBS / PS;     // positions a warp holds in a tile
  constexpr int PL = PW < 32 ? PW : 32;  // ... of them in one pass
  constexpr int R = 32 / PL;       // lanes per position in the scores
  constexpr int C = (D + 31) / 32; // a lane's columns: lane + 32 j
  extern __shared__ __align__(16) unsigned char smem[];

  const int G = H / KV;
  const int chunks = (G + kBlockHeads - 1) / kBlockHeads;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / chunks, hc = blockIdx.y % chunks;
  const int Gb = min(kBlockHeads, G - hc * kBlockHeads);  // block's heads
  const int bh0 = b * H + kvh * G + hc * kBlockHeads;  // its first (b, h)

  // q's Gb*D values, 4 a thread per step, loaded before the block waits
  // on cur_len so the two loads overlap
  constexpr int kQSteps = (HS * HM * D / 4 + kThreads - 1) / kThreads;
  float4 qr[kQSteps];
#pragma unroll
  for (int k = 0; k < kQSteps; ++k) {
    const int e4 = tid + k * kThreads;
    if (e4 < Gb * D / 4) {
      const size_t off = (size_t)bh0 * D + 4 * e4;
      if (q_bf16) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(q) + off);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        qr[k] = make_float4(a.x, a.y, c.x, c.y);
      } else {
        qr[k] = *reinterpret_cast<const float4*>(
            static_cast<const float*>(q) + off);
      }
    }
  }

  // valid: global positions [glo, cur), this block's rows [lo, hi)
  const int cur = cur_len[b];
  int glo = window ? cur - window : 0;
  if (lo_len) glo = max(glo, lo_len[b]);
  const int hi = min(cur - offset, S);
  const int lo = max(glo - offset, 0);
  const int t_lo = lo / kBS;
  const int n = hi > lo ? (hi + kBS - 1) / kBS - t_lo : 0;  // valid tiles
  const int share = n / splits, extra = n % splits;  // the first `extra`
  const int t0 = t_lo + split * share + min(split, extra);  // splits take
  const int t1 = t0 + share + (split < extra);              // one more
  if (t0 >= t1) {  // no valid position: contribute nothing, read nothing
    for (int e = tid; e < Gb * (D + 2); e += kThreads) {
      const int g = e / (D + 2), c = e % (D + 2);
      part_row<D>(part, bh0 + g, split, splits)[c] = c == D ? kNegInf : 0.f;
    }
    return;
  }

  float* Qs = reinterpret_cast<float*>(smem);                      // [Gb][D]
  TC* ring = reinterpret_cast<TC*>(smem + sizeof(float) * Gb * D);  // 2 stages
  const size_t row = (size_t)KV * D;
  const TC* kb = kc + (size_t)b * S * row + (size_t)kvh * D;
  const TC* vb = vc + (size_t)b * S * row + (size_t)kvh * D;

  auto load = [&](int stage, int t) {
    TC* Ks = ring + stage * T::kStage;
    TC* Vs = Ks + kBS * KST * VEC;
    for (int i = tid; i < kBS * NC; i += kThreads) {
      const int r = i / NC, c = i % NC, pos = t * kBS + r;
      const bool in = pos >= lo && pos < hi;
      const size_t off = (size_t)(in ? pos : lo) * row + c * VEC;
      cp_async16(Ks + (r * KST + c) * VEC, kb + off, in);
      cp_async16(Vs + (r * NC + c) * VEC, vb + off, in);
    }
    cp_async_commit();
  };
  load(0, t0);

#pragma unroll
  for (int k = 0; k < kQSteps; ++k) {
    const int e4 = tid + k * kThreads;
    if (e4 < Gb * D / 4) reinterpret_cast<float4*>(Qs)[e4] = qr[k];
  }

  const int HPW = (Gb + HS - 1) / HS;   // heads of a full slice
  const int hs = warp / PS, ps = warp % PS;
  const int g0 = hs * HPW;
  const int nh = max(0, min(HPW, Gb - g0));  // this warp's heads
  const int pi = lane % PL, r = lane / PL;

  float m[HM], l[HM], acc[HM][C];
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[h][j] = 0.f;
  }

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      load(st ^ 1, t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Qs) visible to every warp

    const TC* Ks = ring + st * T::kStage;
    const TC* Vs = Ks + kBS * KST * VEC;
#pragma unroll
    for (int pass = 0; pass < PW / PL; ++pass) {
      const int p_w = ps * PW + pass * PL;     // the pass's first row
      const int pos = t * kBS + p_w + pi;
      const bool valid = pos >= lo && pos < hi;

      // scores: lanes r of position pi each sum chunks r, r+R, ...  The
      // shuffles below run for all HM heads, outside any branch the
      // compiler cannot prove uniform (a shuffle there costs a collective
      // loop); only the arithmetic of heads past nh is skipped.
      float s[HM];
#pragma unroll
      for (int h = 0; h < HM; ++h) s[h] = 0.f;
      const TC* krow = Ks + (p_w + pi) * KST * VEC;
#pragma unroll
      for (int c0 = 0; c0 < NC; c0 += R) {
        const int c = c0 + r;
        if (c >= NC) break;
        float kf[VEC];
        chunk_f32(krow + c * VEC, kf);
#pragma unroll
        for (int h = 0; h < HM; ++h) {
          if (h < nh) {
            const float* qg = Qs + (g0 + h) * D + c * VEC;
#pragma unroll
            for (int v4 = 0; v4 < VEC; v4 += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + v4);
              s[h] = fmaf(qv.x, kf[v4], s[h]);
              s[h] = fmaf(qv.y, kf[v4 + 1], s[h]);
              s[h] = fmaf(qv.z, kf[v4 + 2], s[h]);
              s[h] = fmaf(qv.w, kf[v4 + 3], s[h]);
            }
          }
        }
      }

      // online softmax over the pass's PL positions, per head
      float p[HM];
#pragma unroll
      for (int h = 0; h < HM; ++h) {
#pragma unroll
        for (int o = PL; o < 32; o <<= 1)
          s[h] += __shfl_xor_sync(kFull, s[h], o);
        const float sc = valid ? s[h] * scale : kNegInf;
        float mx = sc;
#pragma unroll
        for (int o = 1; o < PL; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = expf(m[h] - m_new);
        p[h] = valid ? expf(sc - m_new) : 0.f;
        float sum = p[h];
#pragma unroll
        for (int o = 1; o < PL; o <<= 1)
          sum += __shfl_xor_sync(kFull, sum, o);
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int j = 0; j < C; ++j) acc[h][j] *= alpha;
      }

      // PV: lane l holds columns l + 32 j; p of position i from lane i
      const TC* Vw = Vs + p_w * D;
#pragma unroll 4
      for (int i = 0; i < PL; ++i) {
        float vv[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const int col = lane + 32 * j;
          vv[j] = col < D ? to_f32(Vw[i * D + col]) : 0.f;
        }
#pragma unroll
        for (int h = 0; h < HM; ++h) {
          const float ph = __shfl_sync(kFull, p[h], i);
#pragma unroll
          for (int j = 0; j < C; ++j) acc[h][j] = fmaf(ph, vv[j], acc[h][j]);
        }
      }
    }  // pass
    __syncthreads();  // stage st consumed before it is loaded again
  }

  // merge the PS position-slice warps of each head slice; the ring is
  // free now and holds each warp's m, l and acc
  float* Mw = reinterpret_cast<float*>(ring);  // [kWarps][HM]
  float* Lw = Mw + kWarps * HM;
  float* Aw = Lw + kWarps * HM;                // [kWarps][HM][D]
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    if (h < nh) {
      const int wh = warp * HM + h;
      if (lane == 0) {
        Mw[wh] = m[h];
        Lw[wh] = l[h];
      }
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (lane + 32 * j < D) Aw[wh * D + lane + 32 * j] = acc[h][j];
    }
  }
  __syncthreads();
  if (tid < Gb) {  // per head: the block's m and l, each warp's weight
    const int w0 = (tid / HPW) * PS, h = tid % HPW;
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < PS; ++w) M = fmaxf(M, Mw[(w0 + w) * HM + h]);
#pragma unroll
    for (int w = 0; w < PS; ++w) {
      const int wh = (w0 + w) * HM + h;
      const float a = expf(Mw[wh] - M);
      L = fmaf(Lw[wh], a, L);
      Mw[wh] = a;  // read back only by this thread until the barrier
    }
    float* out = part_row<D>(part, bh0 + tid, split, splits);
    out[D] = M;
    out[D + 1] = L;
  }
  __syncthreads();
  for (int e = tid; e < Gb * D; e += kThreads) {
    const int g = e / D, d = e % D;
    const int w0 = (g / HPW) * PS, h = g % HPW;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < PS; ++w) {
      const int wh = (w0 + w) * HM + h;
      A = fmaf(Aw[wh * D + d], Mw[wh], A);
    }
    part_row<D>(part, bh0 + g, split, splits)[d] = A;
  }
}

// One warp per (b, head): merge the splits' (m, l, acc) and normalise.
// Splits are taken 32 at a time (lane s holds split s's m and l) with a
// running max, and the acc loads are unrolled so several are in flight.
template <typename TQ, int D>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part, TQ* __restrict__ o,
                          float* __restrict__ lse, int rows, int splits) {
  constexpr int C = (D + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bh >= rows) return;  // uniform across the warp
  const float* P = part + (size_t)bh * splits * (D + 2);
  float M = kNegInf, L = 0.f, acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    float ms = kNegInf, ls = 0.f;
    if (s0 + lane < splits) {
      ms = P[(s0 + lane) * (D + 2) + D];
      ls = P[(s0 + lane) * (D + 2) + D + 1];
    }
    const float m_new = fmaxf(M, warp_max(ms));
    const float alpha = expf(M - m_new);
    const float w = expf(ms - m_new);  // 0 for an empty split, unless
                                       // every split so far is empty
    L = L * alpha + warp_sum(ls * w);
    M = m_new;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[j] *= alpha;
    const int cnt = min(32, splits - s0);
#pragma unroll 8
    for (int i = 0; i < cnt; ++i) {
      const float wi = __shfl_sync(kFull, w, i);
      const float* ps = P + (s0 + i) * (D + 2);
#pragma unroll
      for (int j = 0; j < C; ++j)
        if (lane + 32 * j < D) acc[j] = fmaf(wi, ps[lane + 32 * j], acc[j]);
    }
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  TQ* ob = o + (size_t)bh * D;
#pragma unroll
  for (int j = 0; j < C; ++j)
    if (lane + 32 * j < D) ob[lane + 32 * j] = from_f32<TQ>(acc[j] * inv);
  if (lse && lane == 0)  // -inf where no split held a valid row
    lse[bh] = L > 0.f ? M + logf(L) : __int_as_float(0xff800000);
}

// One call's arguments: q (B,1,H,D) in f32 or bf16 (q_bf16); caches
// (B,S,KV,D); cur_len (B,) and, for the block entry, lo_len (B,) or
// null; the f32 scratch `part`; o in the output type; lse (B,H) f32 or
// null.  `offset` is the global position of the caches' row 0.
struct Args {
  const void* q;
  int q_bf16;
  const void* kc;
  const void* vc;
  const int* cur;
  const int* lo;
  float* part;
  void* o;
  float* lse;
  int B, S, H, KV, window, offset;
  float scale;
  int splits;
  cudaStream_t stream;
};

template <typename TC, int D, int HS, int HM>
int launch_split(const Args& a) {
  const int G = a.H / a.KV, chunks = (G + kBlockHeads - 1) / kBlockHeads;
  const size_t merge = sizeof(float) * kWarps * HM * (D + 2);
  const size_t ring = Tile<TC, D>::kRingBytes;
  const size_t smem = sizeof(float) * (G < kBlockHeads ? G : kBlockHeads) *
                          D + (ring > merge ? ring : merge);
  auto* kernel = decode_split_kernel<TC, D, HS, HM>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(a.splits, a.KV * chunks, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, a.q_bf16, static_cast<const TC*>(a.kc),
      static_cast<const TC*>(a.vc), a.cur, a.lo, a.part, a.S, a.H, a.KV,
      a.window, a.offset, a.scale, a.splits);
  return (int)cudaGetLastError();
}

// TO: the output's type (q's for decode_attention_launch, f32 for the
// block entry); the split kernel reads q's type from a.q_bf16.
template <typename TO, typename TC, int D>
int launch_typed(const Args& a) {
  // head slices and heads per warp: G <= 8 in one slice of G rounded up
  // to a power of two, G <= 16, 32, 64 in two, four, eight slices of 8;
  // beyond 64 each block holds 64 heads in eight slices
  const int G = a.H / a.KV;
  int rc;
  if (G == 1)
    rc = launch_split<TC, D, 1, 1>(a);
  else if (G == 2)
    rc = launch_split<TC, D, 1, 2>(a);
  else if (G <= 4)
    rc = launch_split<TC, D, 1, 4>(a);
  else if (G <= 8)
    rc = launch_split<TC, D, 1, 8>(a);
  else if (G <= 16)
    rc = launch_split<TC, D, 2, 8>(a);
  else if (G <= 32)
    rc = launch_split<TC, D, 4, 8>(a);
  else
    rc = launch_split<TC, D, 8, 8>(a);
  if (rc != 0) return rc;
  const int rows = a.B * a.H;
  decode_combine_kernel<TO, D><<<(rows + kWarps - 1) / kWarps, kThreads, 0,
                                 a.stream>>>(
      a.part, static_cast<TO*>(a.o), a.lse, rows, a.splits);
  return (int)cudaGetLastError();
}

template <typename TO, typename TC>
int launch_dim(const Args& a, int D) {
  switch (D) {
    case 32:
      return launch_typed<TO, TC, 32>(a);
    case 64:
      return launch_typed<TO, TC, 64>(a);
    case 80:
      return launch_typed<TO, TC, 80>(a);
    case 128:
      return launch_typed<TO, TC, 128>(a);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TO>
int launch_cache(const Args& a, int D, int c_dtype) {
  if (c_dtype == 0) return launch_dim<TO, float>(a, D);
  if (c_dtype == 1) return launch_dim<TO, __nv_bfloat16>(a, D);
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int H, int KV, int splits) {
  return KV < 1 || H % KV != 0 || splits < 1 ||
         (long long)KV * ((H / KV + kBlockHeads - 1) / kBlockHeads) > 65535;
}

}  // namespace

// q, o: (B,1,H,D) contiguous; kc, vc: (B,S,KV,D) contiguous, one type,
// 16-byte aligned; cur_len: (B,) int32; part: f32 scratch of
// B*H*splits*(D+2) values.  dtype codes: 0 = float32, 1 = bfloat16, for
// q (and o) and for the caches separately.  Launches the split kernel,
// grid (splits, KV * ceil(G/64), B), then the combine kernel, on
// `stream`.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* cur_len,
                                       void* part, void* o, int B, int S,
                                       int H, int KV, int D, int window,
                                       float scale, int splits, int q_dtype,
                                       int c_dtype, void* stream) {
  if (bad_shape(H, KV, splits) || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, q_dtype, kc, vc, static_cast<const int*>(cur_len), nullptr,
               static_cast<float*>(part), o, nullptr, B, S, H, KV, window,
               0, scale, splits, static_cast<cudaStream_t>(stream)};
  return q_dtype == 0 ? launch_cache<float>(a, D, c_dtype)
                      : launch_cache<__nv_bfloat16>(a, D, c_dtype);
}

// The block of the cache at global positions [offset, offset + S): the
// same passes over the rows of kc, vc (B,S,KV,D) that are valid in the
// whole cache (positions [max(cur_len - window, lo_len), cur_len), each
// bound where given: window > 0, lo_len not null), and the combine
// writes o (B,1,H,D) in f32, unnormalised by any other block, and lse
// (B,H) = m + log(l) of the block's scaled scores (-inf, with o = 0,
// where the block holds no valid row).  q in f32 or bf16 (q_dtype).
extern "C" int decode_attention_block_launch(
    const void* q, const void* kc, const void* vc, const void* cur_len,
    const void* lo_len, void* part, void* o, void* lse, int B, int S, int H,
    int KV, int D, int window, int offset, float scale, int splits,
    int q_dtype, int c_dtype, void* stream) {
  if (bad_shape(H, KV, splits) || offset < 0 ||
      (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, q_dtype, kc, vc, static_cast<const int*>(cur_len),
               static_cast<const int*>(lo_len), static_cast<float*>(part), o,
               static_cast<float*>(lse), B, S, H, KV, window, offset, scale,
               splits, static_cast<cudaStream_t>(stream)};
  return launch_cache<float>(a, D, c_dtype);
}
