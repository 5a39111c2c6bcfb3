// Fused RMSNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_pallas, body _kernel): per row of d values,
// y = x * rsqrt(mean(x^2) + eps) * scale, statistics in f32, output in
// x's type.  x is f32 or bf16, scale f32 or bf16.  The JAX model code
// never dispatched it (its layers.rmsnorm is plain jnp with the same
// arithmetic); the port's layers.rmsnorm calls it for every RMSNorm of
// the transformer: 2 per layer + the final one, 45 per TinyLlama forward.
//
// Bound: memory traffic.  About 4 operations per element against 8
// bytes moved (f32 in and out): far below the card's ~20 f32 operations
// per byte.  The least traffic is one read of x and one write of y
// (scale is 8 KB, read from L2 by every row).  At the serving path's
// shapes the rows are few (B*S = 1024 at prefill, B = 8 at decode), so
// the decode calls are launch- and latency-bound, not bandwidth-bound.
//
// Design (simple and right first).  The Pallas grid holds a block of
// 256 whole rows in VMEM; here one block of 256 threads owns one row.
// Each thread loads its part of the row with 16-byte vector loads (4 f32
// or 8 bf16) and keeps up to kMaxIter vectors in registers, so a row of
// up to 4096 f32 / 8192 bf16 values is read from device memory once;
// longer rows are read again for the second walk.  Sum of squares in
// f32, warp shuffles then one float per warp in shared memory, rsqrtf,
// then scale and cast on the way out.  A row whose length or address
// does not allow 16-byte vectors takes the same kernel with scalar
// loads.
//
// What a later design would change: several rows per block (a warp per
// row at d = 2048) so the 8-row decode calls fill more than 8 SMs, and
// fusing the norm into the projection that follows it, which removes
// the launch and the write of y altogether.
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, the kernel is launched on that stream,
// and the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxIter = 4;  // 16-byte vectors held in registers per thread

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
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

// Sum of v over the block; every thread gets the total.
__device__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? smem[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) smem[0] = t;
  }
  __syncthreads();
  return smem[0];
}

template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ y, int d, float eps) {
  __shared__ float smem[32];
  using P = Pack<T, VEC>;
  const int nvec = d / VEC;
  const size_t row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * (size_t)d);
  P* yr = reinterpret_cast<P*>(y + row * (size_t)d);

  P held[kMaxIter];
  float ss = 0.f;
#pragma unroll
  for (int it = 0; it < kMaxIter; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < nvec) {
      held[it] = xr[i];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float f = to_f32(held[it].v[e]);
        ss = fmaf(f, f, ss);
      }
    }
  }
  for (int i = threadIdx.x + kMaxIter * kThreads; i < nvec; i += kThreads) {
    const P p = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(p.v[e]);
      ss = fmaf(f, f, ss);
    }
  }
  const float inv = rsqrtf(block_sum(ss, smem) / (float)d + eps);

#pragma unroll
  for (int it = 0; it < kMaxIter; ++it) {
    const int i = threadIdx.x + it * kThreads;
    if (i < nvec) {
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        o.v[e] = from_f32<T>(to_f32(held[it].v[e]) * inv *
                             to_f32(scale[i * VEC + e]));
      yr[i] = o;
    }
  }
  for (int i = threadIdx.x + kMaxIter * kThreads; i < nvec; i += kThreads) {
    const P p = xr[i];
    P o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f32<T>(to_f32(p.v[e]) * inv * to_f32(scale[i * VEC + e]));
    yr[i] = o;
  }
}

template <typename T, typename S>
int launch_typed(const void* x, const void* scale, void* y, long long rows,
                 int d, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid((unsigned)rows);
  if (vec) {
    rmsnorm_kernel<T, S, kVec><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(y), d, eps);
  } else {
    rmsnorm_kernel<T, S, 1><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale),
        static_cast<T*>(y), d, eps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, d) contiguous; scale: (d,).  dtype codes: 0 = float32,
// 1 = bfloat16, for x (and y) and for scale separately.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              long long rows, int d, float eps, int x_dtype,
                              int s_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && s_dtype == 0)
    return launch_typed<float, float>(x, scale, y, rows, d, eps, s);
  if (x_dtype == 0 && s_dtype == 1)
    return launch_typed<float, __nv_bfloat16>(x, scale, y, rows, d, eps, s);
  if (x_dtype == 1 && s_dtype == 0)
    return launch_typed<__nv_bfloat16, float>(x, scale, y, rows, d, eps, s);
  if (x_dtype == 1 && s_dtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d,
                                                      eps, s);
  return (int)cudaErrorInvalidValue;
}
