// Flash-decode: one query token per sequence against a KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas, body _kernel): q (B,1,H,D) against caches
// (B,S,KV,D) with cur_len (B,) valid entries per row; positions
// >= cur_len, and with a window those < cur_len - window, are masked
// with the reference's finite -1e30; cache blocks with no valid position
// are skipped; online softmax with f32 m, l, acc and p kept in f32 for
// the PV product; output acc / max(l, 1e-30) in q's type.  q and the
// cache may differ in type: the serving path's default is f32 q over a
// bf16 cache.  22 calls per TinyLlama decode step, q (B,1,32,64),
// caches (B,max_len,4,64).
//
// Bound: memory traffic.  Each valid cache row (k and v, D values each)
// is read once for the G = H/KV query heads of its group: 4*G*D
// operations against 2*D*2 bytes (bf16), ~8 operations per byte at G=8,
// under the card's ~20 f32 operations per byte.  The least traffic is
// the valid part of the cache plus q and o.
//
// Design (simple and right first).  The Pallas grid (B, KV, S/bs) runs
// the sequence axis in order with m, l, acc in VMEM.  Here one block of
// 256 threads owns one (b, kv head) and walks the valid cache in tiles
// of 64 positions, read in place from the (B,S,KV,D) layout: each tile
// of k and v goes to shared memory as f32 (k rows padded by one float).
// Warp w owns query heads w, w+8, ... of the group (G <= 32): its lanes
// hold the scores of positions lane and lane+32, reduce the max and sum
// with shuffles, and accumulate ceil(D/32) output values each, at
// columns lane + 32j masked at D (at D = 80 lanes 0-15 hold 3 and lanes
// 16-31 hold 2), broadcasting p by shuffle in the PV loop, so all G
// heads share one read of each cache row (GQA's point) and nothing but
// the tiles needs a barrier.
// At B=8, KV=4 the grid is 32 blocks on 132 SMs.  Zamba2-2.7b's shared
// attention (9 calls per decode step, H = KV = 32, G = 1, D = 80) gives
// 256 blocks, but with G = 1 only warp 0 of the 8 has a query head.
//
// What a later design would change: split-K over the sequence (several
// blocks per (b, kv head), each on a slice of the cache, and a small
// combine pass of their (m, l, acc)) so small batches fill the card;
// 16-byte loads and a cp.async/TMA ring of cache tiles.
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, the kernel is launched on that stream,
// and the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 64;        // cache positions per tile
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHPW = 4;     // query heads per warp: G <= 32
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)G * D + kBS * (D + 1) + kBS * D);
}

template <typename TQ, typename TC, int D>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const TQ* __restrict__ q, const TC* __restrict__ kc,
                  const TC* __restrict__ vc, const int* __restrict__ cur_len,
                  TQ* __restrict__ o, int S, int H, int KV, int window,
                  float scale) {
  extern __shared__ float smem[];
  const int G = H / KV;
  float* Qs = smem;                  // [G][D]
  float* Ks = Qs + G * D;            // [kBS][D + 1]
  float* Vs = Ks + kBS * (D + 1);    // [kBS][D]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const TQ* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;
  const size_t row = (size_t)KV * D;
  const TC* kb = kc + (size_t)b * S * row + (size_t)kvh * D;
  const TC* vb = vc + (size_t)b * S * row + (size_t)kvh * D;

  for (int e = tid; e < G * D; e += kThreads) Qs[e] = to_f32(qb[e]);

  constexpr int C = (D + 31) / 32;  // a lane's columns: lane + 32 j, j < C
  float m[kMaxHPW], l[kMaxHPW], acc[kMaxHPW][C];
#pragma unroll
  for (int hh = 0; hh < kMaxHPW; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) acc[hh][j] = 0.f;
  }

  const int cur = cur_len[b];
  const int hi = min(cur, S);                       // valid: [lo, hi)
  const int lo = window ? max(0, cur - window) : 0;

  for (int s0 = (lo / kBS) * kBS; s0 < hi; s0 += kBS) {
    __syncthreads();  // Qs written / the previous tile consumed
    for (int e = tid; e < kBS * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = s0 + r < S;
      const size_t off = (size_t)(s0 + r) * row + c;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[off]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    const int p0 = s0 + lane, p1 = s0 + lane + 32;
    const bool ok0 = p0 >= lo && p0 < hi, ok1 = p1 >= lo && p1 < hi;
#pragma unroll
    for (int hh = 0; hh < kMaxHPW; ++hh) {
      const int g = warp + hh * kWarps;
      if (g >= G) break;  // uniform across the warp
      const float* qg = Qs + g * D;
      float s_0 = 0.f, s_1 = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qv = qg[d];
        s_0 = fmaf(qv, Ks[lane * (D + 1) + d], s_0);
        s_1 = fmaf(qv, Ks[(lane + 32) * (D + 1) + d], s_1);
      }
      s_0 = ok0 ? s_0 * scale : kNegInf;
      s_1 = ok1 ? s_1 * scale : kNegInf;
      const float m_new = fmaxf(m[hh], warp_max(fmaxf(s_0, s_1)));
      const float alpha = expf(m[hh] - m_new);
      const float e0 = expf(s_0 - m_new), e1 = expf(s_1 - m_new);
      l[hh] = l[hh] * alpha + warp_sum(e0 + e1);
#pragma unroll
      for (int j = 0; j < C; ++j) acc[hh][j] *= alpha;
      m[hh] = m_new;
#pragma unroll 4
      for (int c = 0; c < kBS; ++c) {
        const float p = __shfl_sync(0xffffffffu, c < 32 ? e0 : e1, c & 31);
#pragma unroll
        for (int j = 0; j < C; ++j)
          if (lane + 32 * j < D)
            acc[hh][j] = fmaf(p, Vs[c * D + lane + 32 * j], acc[hh][j]);
      }
    }
  }

  TQ* ob = o + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int hh = 0; hh < kMaxHPW; ++hh) {
    const int g = warp + hh * kWarps;
    if (g >= G) break;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (lane + 32 * j < D)
        ob[g * D + lane + 32 * j] = from_f32<TQ>(acc[hh][j] * inv);
  }
}

template <typename TQ, typename TC, int D>
int launch_typed(const void* q, const void* kc, const void* vc,
                 const int* cur, void* o, int B, int S, int H, int KV,
                 int window, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<TQ, TC, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(KV, B);
  decode_kernel<TQ, TC, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TC*>(kc),
      static_cast<const TC*>(vc), cur, static_cast<TQ*>(o), S, H, KV, window,
      scale);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch_dim(const void* q, const void* kc, const void* vc, const int* cur,
               void* o, int B, int S, int H, int KV, int D, int window,
               float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_typed<TQ, TC, 32>(q, kc, vc, cur, o, B, S, H, KV,
                                      window, scale, stream);
    case 64:
      return launch_typed<TQ, TC, 64>(q, kc, vc, cur, o, B, S, H, KV,
                                      window, scale, stream);
    case 80:
      return launch_typed<TQ, TC, 80>(q, kc, vc, cur, o, B, S, H, KV,
                                      window, scale, stream);
    case 128:
      return launch_typed<TQ, TC, 128>(q, kc, vc, cur, o, B, S, H, KV,
                                       window, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ>
int launch_cache(const void* q, const void* kc, const void* vc,
                 const int* cur, void* o, int B, int S, int H, int KV, int D,
                 int window, float scale, int c_dtype, cudaStream_t stream) {
  if (c_dtype == 0)
    return launch_dim<TQ, float>(q, kc, vc, cur, o, B, S, H, KV, D, window,
                                 scale, stream);
  if (c_dtype == 1)
    return launch_dim<TQ, __nv_bfloat16>(q, kc, vc, cur, o, B, S, H, KV, D,
                                         window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, o: (B,1,H,D) contiguous; kc, vc: (B,S,KV,D) contiguous, one type;
// cur_len: (B,) int32.  dtype codes: 0 = float32, 1 = bfloat16, for q
// (and o) and for the caches separately.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* cur_len,
                                       void* o, int B, int S, int H, int KV,
                                       int D, int window, float scale,
                                       int q_dtype, int c_dtype,
                                       void* stream) {
  if (KV < 1 || H % KV != 0 || H / KV > kMaxHPW * kWarps)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cur = static_cast<const int*>(cur_len);
  if (q_dtype == 0)
    return launch_cache<float>(q, kc, vc, cur, o, B, S, H, KV, D, window,
                               scale, c_dtype, s);
  if (q_dtype == 1)
    return launch_cache<__nv_bfloat16>(q, kc, vc, cur, o, B, S, H, KV, D,
                                       window, scale, c_dtype, s);
  return (int)cudaErrorInvalidValue;
}
