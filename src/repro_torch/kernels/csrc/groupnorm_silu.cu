// Fused GroupNorm + SiLU over NHWC activations, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/groupnorm_silu/kernel.py
// (groupnorm_silu_pallas, body _kernel): per image and channel group,
// f32 mean, then the centred (population) variance, normalize, per-channel
// f32 scale and bias, SiLU, output in the input's type (f32 or bf16).
// Groups are contiguous channel blocks of C/G channels.
//
// Bound: memory traffic.  Each element needs about a dozen f32
// operations against 8 bytes moved (f32 in and out), far below the
// card's ~20 operations per byte at its f32 CUDA-core rate.  The least
// traffic is one read of x and one write of y.
//
// Design (simple and right first).  The Pallas grid holds one whole
// image per program in VMEM; a 32x32x384 f32 image is 1.5 MB, far over
// a block's 227 KB of shared memory, so that tiling does not carry over.
// Here one block of 256 threads owns one (image, group) pair: grid (G, B),
// 512 blocks at B=16, G=32.  It walks its H*W*C/G values three times:
// sum for the mean, sum of squared deviations for the variance, then
// normalize and write.  The second and third walks mostly hit L1/L2
// (a group is at most 48 KB at the U-Net's shapes), so device-memory
// traffic stays near one read and one write, but every walk issues
// narrow loads: C/G channels of a pixel are 16-48 contiguous bytes,
// then a stride of C to the next pixel.
//
// What a later design would change: one read of x held in registers or
// shared memory; coalesced 16-byte loads across a pixel's channels (a
// block per image and row range, all groups' partial sums in shared
// memory, a second tiny pass to combine them); and fewer launches at the
// 4x4 shapes, where launch latency dominates the 32 KB of traffic.
//
// C interface (route: nvcc -shared, loaded with ctypes): device
// pointers and the stream arrive as void*, launched on that stream, and
// the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// Sum of v over the block; every thread gets the total.  smem holds one
// float per warp and is free again when the function returns.
__device__ float block_sum(float v, float* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  float t = lane < (kThreads >> 5) ? smem[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  __syncthreads();
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
groupnorm_silu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int hw, int channels, int cg, float eps) {
  __shared__ float smem[kThreads / 32];
  const int g = blockIdx.x;
  const int64_t base =
      (int64_t)blockIdx.y * hw * channels + (int64_t)g * cg;
  const int n = hw * cg;

  // walk 1: mean
  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int p = e / cg, j = e - p * cg;
    s += to_f32(x[base + (int64_t)p * channels + j]);
  }
  const float mean = block_sum(s, smem) / (float)n;

  // walk 2: centred variance (not E[x^2] - mean^2, which loses digits)
  float q = 0.f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int p = e / cg, j = e - p * cg;
    const float d = to_f32(x[base + (int64_t)p * channels + j]) - mean;
    q += d * d;
  }
  const float rstd = rsqrtf(block_sum(q, smem) / (float)n + eps);

  // walk 3: normalize, scale and bias in f32, SiLU, store in x's type
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int p = e / cg, j = e - p * cg;
    const int64_t i = base + (int64_t)p * channels + j;
    const int c = g * cg + j;
    const float v = (to_f32(x[i]) - mean) * rstd * scale[c] + bias[c];
    y[i] = from_f32<T>(v / (1.f + expf(-v)));
  }
}

}  // namespace

// x, y: (batch, hw, channels) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); scale, bias: (channels,) f32.  groups divides channels.
extern "C" int groupnorm_silu_launch(const void* x, const void* scale,
                                     const void* bias, void* y, int batch,
                                     int hw, int channels, int groups,
                                     float eps, int is_bf16, void* stream) {
  if (batch <= 0 || batch > 65535 || hw <= 0 || channels <= 0 ||
      groups <= 0 || channels % groups != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(groups, batch);
  const int cg = channels / groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    groupnorm_silu_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<__nv_bfloat16*>(y), hw, channels, cg, eps);
  } else {
    groupnorm_silu_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<const float*>(bias), static_cast<float*>(y), hw,
        channels, cg, eps);
  }
  return (int)cudaGetLastError();
}
