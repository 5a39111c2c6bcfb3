// Fused RMSNorm over the last axis, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (rmsnorm_pallas, body _kernel): per row of d values,
// y = x * rsqrt(mean(x^2) + eps) * scale, statistics in f32, output in
// x's type.  x is f32 or bf16, scale f32 or bf16.  The JAX model code
// never dispatched it (its layers.rmsnorm is plain jnp with the same
// arithmetic); the port's layers.rmsnorm calls it for every RMSNorm:
// 45 per TinyLlama forward (d 2048), 127 per Zamba2 forward (73 at
// d 2560, 54 over d_inner 5120 in the gated norm).
//
// Bound: memory traffic.  About 4 operations per element against 8
// bytes moved (f32 in and out): far below the card's ~20 f32 operations
// per byte.  The least traffic is one read of x and one write of y
// (scale, at most 20 KB, comes from L2 for every row).  At prefill
// (B*S = 1024 rows) the call streams x through; at decode (B = 8 rows
// on 8 SMs) it is one chain of latencies on top of the launch: x load,
// the sum across the block, the store.
//
// Design.  One block per row (the Pallas grid holds a block of 256 rows
// in VMEM; here a row's block spans the row).  The plan (ops.plan, in
// Python, passed in) gives threads and nv so that threads * nv vectors
// of 16 bytes hold the whole row with the fewest idle lanes, nv near 4:
// f32 d = 2048: 128 x 4, 2560: 160 x 4, 5120: 320 x 4.  So x is read
// from device memory once at every path width.  Each thread issues its
// nv loads of x and then its nv loads of scale (16 bytes of x's width,
// in scale's own type) before any arithmetic, so the scale's round trip
// overlaps x's instead of following the reduction.  The sum of squares
// is taken per thread in f32, across each warp by shuffles, and across
// the block in one barrier: every warp writes its total to shared
// memory, and after one __syncthreads every warp adds all the partials
// in the same shuffle tree, so every thread holds the same total.  Then
// normalise in registers and store with 16-byte stores.  A row whose
// length or addresses do not allow 16-byte vectors takes the same
// kernel with scalar loads.  A row wider than the largest block holds
// (512 threads x 5 vectors, 1024 x 5 scalars) streams its leading
// chunks once for the sum and reads them again after it (chunks > 1);
// no path row is that wide.
//
// Launch bounds: 1024 threads for scalar loads or nv <= 2, 512 for more
// 16-byte vectors, so that x and scale held (up to 5 vectors each) stay
// within 128 registers a thread.
//
// Measured and dropped (tools/time_rmsnorm.py; numbers in PERF.md): scale
// loaded after the sum, and a second barrier to broadcast the total
// (each slower at decode); rows staged in shared memory by cp.async
// (0.4-0.5 us slower at decode, slower at prefill); register caps that
// buy more blocks an SM (spills, up to 2.6x slower); plans that aim for
// 256 or 320 threads instead of 4 vectors a thread (up to 13% slower at
// prefill).  Left: at (8, 128, 5120) and (16, 128, 2560) f32 with x
// L2-warm, F.rms_norm is up to 7% faster: it holds nothing, so its
// 128-thread blocks at 32 registers keep every row of the call in
// flight, where this kernel keeps 3 rows an SM.  With x cold it is the
// other way round (14.2 us against 17.5 at (8, 128, 5120)).  Fusing the
// norm into the projection that follows it would remove the launch and
// the write of y altogether.
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, the kernel is launched on that stream,
// and the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC, int NV>
constexpr int max_threads() {
  return VEC == 1 || NV <= 2 ? 1024 : 512;
}

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

// N elements loaded and stored in pieces of at most 16 bytes.
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Pack {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ float sum_sq(float ss, const Pack<T, N>& p) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float f = to_f32(p.v[e]);
    ss = fmaf(f, f, ss);
  }
  return ss;
}

template <typename T, typename S, int N>
__device__ __forceinline__ Pack<T, N> normed(const Pack<T, N>& p,
                                             const Pack<S, N>& s,
                                             float inv) {
  Pack<T, N> o;
#pragma unroll
  for (int e = 0; e < N; ++e)
    o.v[e] = from_f32<T>(to_f32(p.v[e]) * inv * to_f32(s.v[e]));
  return o;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block in one barrier: each warp's total goes to
// shared memory, then every warp adds all the partials in the same
// shuffle tree, so every thread gets the same total.
__device__ __forceinline__ float block_sum(float v, float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  return warp_sum(lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f);
}

// One block per row; threads * NV vectors of VEC elements a chunk.
template <typename T, typename S, int VEC, int NV>
__global__ void __launch_bounds__(max_threads<VEC, NV>())
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ y, int d, int chunks, float eps) {
  __shared__ float part[32];
  using P = Pack<T, VEC>;
  using Q = Pack<S, VEC>;
  const int nvec = d / VEC;
  const int step = blockDim.x;
  const int span = NV * step;
  const size_t row = blockIdx.x;
  const P* xr = reinterpret_cast<const P*>(x + row * (size_t)d);
  const Q* sr = reinterpret_cast<const Q*>(scale);
  P* yr = reinterpret_cast<P*>(y + row * (size_t)d);

  // Chunks before the last (rows wider than a block holds): x streams
  // through once for the sum.
  float ss = 0.f;
  const int last = (chunks - 1) * span;
  for (int base = 0; base < last; base += span) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = base + threadIdx.x + k * step;
      if (i < nvec) ss = sum_sq(ss, xr[i]);
    }
  }

  // The last (usually only) chunk, held: every load issued first, x's
  // and then scale's, before any arithmetic.  Idle lanes' packs stay
  // unset: zero-filling them, or clamping the index so that every load
  // runs, cost 5-15% at prefill on the H100.
  P held[NV];
  Q sc[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = last + threadIdx.x + k * step;
    if (i < nvec) held[k] = xr[i];
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = last + threadIdx.x + k * step;
    if (i < nvec) sc[k] = sr[i];
  }
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = last + threadIdx.x + k * step;
    if (i < nvec) ss = sum_sq(ss, held[k]);
  }
  const float inv = rsqrtf(block_sum(ss, part) / (float)d + eps);

#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = last + threadIdx.x + k * step;
    if (i < nvec) yr[i] = normed(held[k], sc[k], inv);
  }
  // The chunks before the last, read again.
  for (int base = 0; base < last; base += span) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int i = base + threadIdx.x + k * step;
      if (i < nvec) yr[i] = normed(xr[i], sr[i], inv);
    }
  }
}

struct Args {
  const void* x;
  const void* scale;
  void* y;
  long long rows;
  int d;
  float eps;
  int threads;
  int chunks;
  cudaStream_t stream;
};

template <typename T, typename S, int VEC, int NV>
int go(const Args& a) {
  if (a.threads < 32 || a.threads % 32 != 0 ||
      a.threads > max_threads<VEC, NV>())
    return (int)cudaErrorInvalidValue;
  rmsnorm_kernel<T, S, VEC, NV><<<(unsigned)a.rows, a.threads, 0,
                                   a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const S*>(a.scale),
      static_cast<T*>(a.y), a.d, a.chunks, a.eps);
  return (int)cudaGetLastError();
}

// nv in 1..5; 16-byte vectors from 2 up (at nv = 1 and 6 ptxas spilled
// a few bytes of some type pairs).
template <typename T, typename S, int VEC>
int by_nv(const Args& a, int nv) {
  switch (nv) {
    case 1:
      if constexpr (VEC == 1) return go<T, S, VEC, 1>(a);
      break;
    case 2: return go<T, S, VEC, 2>(a);
    case 3: return go<T, S, VEC, 3>(a);
    case 4: return go<T, S, VEC, 4>(a);
    case 5: return go<T, S, VEC, 5>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename S>
int launch_typed(const Args& a, int nv, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  // the plan must cover the row
  if (a.chunks < 1 ||
      (long long)a.chunks * nv * a.threads * vec < (long long)a.d)
    return (int)cudaErrorInvalidValue;
  if (vec == 1) return by_nv<T, S, 1>(a, nv);
  const bool aligned = a.d % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(a.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(a.scale) % 16 == 0;
  if (vec != kVec || !aligned) return (int)cudaErrorInvalidValue;
  return by_nv<T, S, kVec>(a, nv);
}

}  // namespace

// x, y: (rows, d) contiguous; scale: (d,).  dtype codes: 0 = float32,
// 1 = bfloat16, for x (and y) and for scale separately.  threads, nv,
// vec, chunks: the plan of ops.plan (threads * nv * vec * chunks >= d;
// vec = 16 / sizeof(x's element) or 1).
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* y,
                              long long rows, int d, float eps, int x_dtype,
                              int s_dtype, int threads, int nv, int vec,
                              int chunks, void* stream) {
  const Args a{x,   scale,   y,      rows,
               d,   eps,     threads, chunks,
               static_cast<cudaStream_t>(stream)};
  if (x_dtype == 0 && s_dtype == 0)
    return launch_typed<float, float>(a, nv, vec);
  if (x_dtype == 0 && s_dtype == 1)
    return launch_typed<float, __nv_bfloat16>(a, nv, vec);
  if (x_dtype == 1 && s_dtype == 0)
    return launch_typed<__nv_bfloat16, float>(a, nv, vec);
  if (x_dtype == 1 && s_dtype == 1)
    return launch_typed<__nv_bfloat16, __nv_bfloat16>(a, nv, vec);
  return (int)cudaErrorInvalidValue;
}
