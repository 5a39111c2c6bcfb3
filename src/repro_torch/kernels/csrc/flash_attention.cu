// Forward flash attention (GQA, causal with sequence ends aligned,
// optional sliding window), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _kernel): q (B,Sq,H,D) against k, v
// (B,Skv,KV,D), query head h reading KV head h / G (G = H/KV); query i
// sits at key position i + Skv - Sq; keys after a query (causal) or
// window or more positions before it are masked with the finite -1e30
// the reference uses; online softmax with f32 running max m, sum l and
// accumulator; key tiles wholly past the diagonal or outside the window
// are skipped; output acc / max(l, 1e-30) in q's type.  On the serving
// path it runs once per layer per prefill (22 per TinyLlama prefill),
// q (B,S,32,64) and k/v (B,S,4,64) in float32.
//
// Bound: at prefill lengths (S = 128) both bounds are small and close.
// Per unmasked (query, key) pair, 2*D operations for QK^T and 2*D for
// PV; causal leaves S*(S+1)/2 pairs per head.  At B=8, S=128, H=32
// that is 541 MFLOP (8.1 us at 67 TFLOP/s f32 on CUDA cores) against
// 18.9 MB for q, o, k and v (5.6 us at 3.35 TB/s): operations bound
// the call, slightly.  Zamba2-2.7b's shared attention block calls it
// once per group (9 per prefill) at q, k, v (B,S,32,80).
//
// Design (simple and right first).  The Pallas grid is (B, H, Sq/bq,
// Skv/bk) with the kv axis run in order on one core and m, l, acc kept
// in VMEM scratch across it.  Here one block of 256 threads owns one
// (b, h, 64-row query tile) and walks its key tiles of 64 in a loop.
// q, k and v are read in place in their (B,S,heads,D) layout (no
// transposed copies, unlike the reference's swapaxes).  The tile's q
// and each k/v tile are converted to f32 in shared memory (rows padded
// by one float against bank conflicts).  Threads form a 16x16 grid; a
// thread owns query rows ty+16i (i < 4) and key columns tx+16j of the
// 64x64 score tile, and output columns tx+16j of the 64xD accumulator
// in registers (D/16 of them: D = 32, 64, 80 or 128), so the running
// max and sum of a row live in the 16 threads of one half-warp and
// reduce with shuffles.  P goes through shared memory to the PV product.  All arithmetic is f32 FMA on the
// CUDA cores: the default path is f32, and TF32 tensor cores would
// break parity with the reference.
//
// What a later design would change: bf16 (or TF32 where the caller
// allows it) mma.sync / wgmma for QK^T and PV with K/V tiles brought in
// by TMA into a multi-stage ring, 16-byte loads, and all G query heads
// of a KV head in one block so k and v are read once per group.
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, the kernel is launched on that stream,
// and the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
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

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1));
}

// Reduce over the 16 lanes of a half-warp (lanes that share ty).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int Sq,
                     int Skv, int H, int KV, int causal, int window,
                     int q_offset, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [kBQ][D + 1]
  float* Ks = Qs + kBQ * (D + 1);      // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);      // [kBK][D]
  float* Ps = Vs + kBK * D;            // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KV * D;
  const T* qb = q + (size_t)b * Sq * q_stride + (size_t)h * D;
  const T* kb = k + (size_t)b * Skv * kv_stride + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Skv * kv_stride + (size_t)kvh * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    Qs[r * (D + 1) + c] =
        q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * q_stride + c]) : 0.f;
  }

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  // keys any row of this tile can see: [k_lo, k_hi)
  const int qa_first = q_offset + q0;
  const int qa_last = q_offset + min(q0 + kBQ, Sq) - 1;
  const int k_lo = window ? max(0, qa_first - window + 1) : 0;
  const int k_hi = causal ? min(Skv, qa_last + 1) : Skv;

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's Ks, Vs, Ps are consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Skv;
      const size_t off = (size_t)(k0 + r) * kv_stride + c;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[off]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_offset + q0 + r;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool valid = kpos < Skv;
        if (causal) valid = valid && qpos >= kpos;
        if (window) valid = valid && qpos - kpos < window;
        s[i][j] = valid ? s[i][j] * scale : kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mt));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[r * (kBK + 1) + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * alpha + half_warp_sum(ps);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float vv = Vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + (size_t)b * Sq * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      ob[(size_t)(q0 + r) * q_stride + tx + 16 * j] =
          from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int B, int Sq, int Skv, int H, int KV, int causal,
                 int window, int q_offset, float scale,
                 cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, H, KV, causal,
      window, q_offset, scale);
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

// q, o: (B,Sq,H,D); k, v: (B,Skv,KV,D); all contiguous, one type
// (dtype 0 = float32, 1 = bfloat16).  q_offset = Skv - Sq.
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
