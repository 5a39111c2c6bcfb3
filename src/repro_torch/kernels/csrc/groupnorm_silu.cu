// Fused GroupNorm + SiLU over NHWC activations, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/groupnorm_silu/kernel.py
// (groupnorm_silu_pallas, body _kernel): per image and channel group,
// f32 mean, then the centred (population) variance, normalize, per-channel
// f32 scale and bias, SiLU, output in the input's type (f32 or bf16).
// Groups are contiguous channel blocks of cg = C/G channels.
//
// Bound: memory traffic.  Each element needs about a dozen f32
// operations against 8 bytes moved (f32 in and out), far below the
// card's ~20 operations per byte at its f32 CUDA-core rate.  The least
// traffic is one read of x and one write of y.
//
// Design.  The Pallas grid holds one whole image per program in VMEM.
// Here one block owns one image times a slab: a contiguous run of whole
// groups, chosen per shape in Python (kernels/groupnorm_silu/ops.py:
// plan) and passed in; the grid is (C / slab, batch), one launch per call.
//
// - A thread keeps one 16-byte column of the slab (4 f32 or 8 bf16
//   channels) for every row (pixel) it covers, so it knows its
//   channels' groups without a division per element, and neighbouring
//   threads load neighbouring 16 bytes of a pixel's slab: a warp reads
//   whole 32-byte sectors, in rows of 32 to 128 bytes (ops.ROW_BYTES).
// - The thread holds its nv loads in registers (the block's tile, at
//   most 64 KB), so device memory sees one read of x and one write of y.
// - Sums: per thread over its rows in f32, then per group in double by a
//   team of lanes over the block's per-thread sums in shared memory and
//   warp shuffles (one barrier).  Every thread then reads its
//   groups' sums and keeps the mean as an f32 pair (hi + lo), so x - mean
//   loses no digit to the mean's rounding at large offsets.  The same
//   for the centred sum of squares, from the tile in registers, gives
//   rstd.  Then normalize, scale and bias, SiLU (__expf, __fdividef), and
//   16-byte stores.
//
// A block whose pixels do not fit nv loads a thread (an image too large
// for a block's registers) walks them in chunks and reads x again for
// the second and third passes; the U-Net's shapes never do.  A row whose
// length or address does not allow 16-byte loads takes the same kernel
// with scalar loads (vec = 1).
//
// Measured and dropped (PERF.md): splitting an image's pixels over
// a thread-block cluster of 2-8 blocks, reduced through distributed
// shared memory, was slower per forward at B = 1, 8 and 16, by up to
// 6 us a call, at every U-Net shape but 32x32x384 (there 0.4 us faster
// at B = 1, 3 us with 96-byte rows at B = 16); a tile in shared memory
// (up to 192 KB, cp.async) lost to the tile in registers.
//
// What a later design would change: the small calls (4x4 and 8x8
// images, 24 of the U-Net's 45) sit on a floor of ~3 us (launch, one
// load and one store latency, two barriers), not on their 0.1-1.3 us of
// traffic; only fewer launches (CUDA graphs over the step, or fusing
// GroupNorm + SiLU into the convolution that follows) remove that.  At
// 32x32x384 whole groups of 12 channels in 64 KB leave 48-byte rows.
// No product here, so no wgmma or TMA.
//
// C interface (route: nvcc -shared, loaded with ctypes): device
// pointers and the stream arrive as void*, launched on that stream, and
// the function returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;

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

// The block's per-group sums of `acc` (VEC per-thread column sums) into
// out[0..ng), in double, followed by a barrier.  part: nthreads * VEC
// floats, laid out [row of the pass][channel of the slab] since
// tid * VEC = row * slab + col * VEC.  A team of m lanes (a power of two,
// within a warp; 1 when the block is not whole warps) sums one group's
// rows x cgs values, then shuffles.
template <int VEC>
__device__ __forceinline__ void block_group_sums(const float (&acc)[VEC],
                                                 float* part, double* out,
                                                 int slab, int cgs, int ng,
                                                 int rows) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
#pragma unroll
  for (int j = 0; j < VEC; ++j) part[tid * VEC + j] = acc[j];
  __syncthreads();
  int m = nthreads % 32 ? 1 : 32;  // shuffles need whole warps
  while (m > 1 && nthreads / m < ng) m >>= 1;
  const int team = tid / m, lane = tid % m, teams = nthreads / m;
  const int dq = m / cgs, dr = m % cgs;  // m values on: dq rows, dr channels
  for (int base = 0; base < ng; base += teams) {  // the same trips a warp
    const int g = base + team;
    double t = 0.0;
    if (g < ng) {
      const float* pg = part + g * cgs;
      int r = lane / cgs, kk = lane % cgs;
      double f0 = 0.0, f1 = 0.0, f2 = 0.0, f3 = 0.0;
      if (dr == 0) {  // one channel kk, rows dq apart
        for (; r + 3 * dq < rows; r += 4 * dq) {
          f0 += pg[r * slab + kk];
          f1 += pg[(r + dq) * slab + kk];
          f2 += pg[(r + 2 * dq) * slab + kk];
          f3 += pg[(r + 3 * dq) * slab + kk];
        }
        for (; r < rows; r += dq) f0 += pg[r * slab + kk];
      } else {
        while (r < rows) {
          f0 += pg[r * slab + kk];
          r += dq;
          kk += dr;
          if (kk >= cgs) {
            kk -= cgs;
            ++r;
          }
        }
      }
      t = (f0 + f1) + (f2 + f3);
    }
    for (int o = m >> 1; o > 0; o >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, o);
    if (g < ng && lane == 0) out[g] = t;
  }
  __syncthreads();
}

template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
groupnorm_silu_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int hw, int channels, int cgs, int slab, int chunks,
                      float eps) {
  using P = Pack<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int rvec = slab / VEC;        // loads per pixel row of the slab
  const int rows = nthreads / rvec;   // pixel rows per pass of the block
  const int ng = slab / cgs;          // groups in the slab
  const int col = tid % rvec, row0 = tid / rvec;
  const int64_t first = ((int64_t)blockIdx.y * hw + row0) * channels +
                        (int64_t)blockIdx.x * slab + col * VEC;
  const int64_t step = (int64_t)rows * channels;  // one pass of the block
  const T* xs = x + first;
  T* ys = y + first;

  double* stat = reinterpret_cast<double*>(smem);  // [2][ng]: sums
  float* part = reinterpret_cast<float*>(stat + 2 * ng);  // [nthreads*VEC]
  float* sb = part + nthreads * VEC;  // [2][slab]: the slab's scale, bias

  P tile[NV];
  auto held = [&](int c, int i) { return row0 + (c * NV + i) * rows < hw; };
  auto load = [&](int c) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (held(c, i))
        tile[i] = *reinterpret_cast<const P*>(xs + (c * NV + i) * step);
  };

  // pass 1: mean
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    load(c);
    if (c == 0)  // in flight beside the tile; read in pass 3
      for (int e = tid; e < slab; e += nthreads) {
        sb[e] = scale[blockIdx.x * slab + e];
        sb[slab + e] = bias[blockIdx.x * slab + e];
      }
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (held(c, i)) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[j] += to_f32(tile[i].v[j]);
      }
  }
  const double inv_count = 1.0 / ((double)hw * cgs);
  block_group_sums<VEC>(acc, part, stat, slab, cgs, ng, rows);
  int grp[VEC];  // this thread's channels: their groups in the slab
  float mh[VEC], ml[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    grp[j] = (col * VEC + j) / cgs;
    const double m = stat[grp[j]] * inv_count;
    mh[j] = (float)m;
    ml[j] = (float)(m - (double)(float)m);
  }

  // pass 2: centred variance (not E[x^2] - mean^2, which loses digits)
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int c = 0; c < chunks; ++c) {
    if (chunks > 1) load(c);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (held(c, i)) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = (to_f32(tile[i].v[j]) - mh[j]) - ml[j];
          acc[j] = fmaf(d, d, acc[j]);
        }
      }
  }
  block_group_sums<VEC>(acc, part, stat + ng, slab, cgs, ng, rows);
  float a[VEC], b[VEC];  // rstd * scale, bias of this thread's channels
#pragma unroll
  for (int j = 0; j < VEC; ++j) {  // f32 var + eps, as torch
    a[j] = rsqrtf((float)(stat[ng + grp[j]] * inv_count) + eps) *
           sb[col * VEC + j];
    b[j] = sb[slab + col * VEC + j];
  }

  // pass 3: normalize, scale and bias in f32, SiLU, store in x's type
  for (int c = 0; c < chunks; ++c) {
    if (chunks > 1) load(c);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (held(c, i)) {
        P o;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float d = (to_f32(tile[i].v[j]) - mh[j]) - ml[j];
          const float v = fmaf(d, a[j], b[j]);
          o.v[j] = from_f32<T>(__fdividef(v, 1.f + __expf(-v)));
        }
        *reinterpret_cast<P*>(ys + (c * NV + i) * step) = o;
      }
  }
}

template <typename T, int VEC>
int launch_typed(const void* x, const void* scale, const void* bias, void* y,
                 int batch, int hw, int channels, int cgs, float eps,
                 int slab, int threads, int nv, cudaStream_t stream) {
  const int rows = threads / (slab / VEC);
  const int passes = (hw + rows - 1) / rows;
  const int chunks = (passes + nv - 1) / nv;
  const size_t smem = 2 * (slab / cgs) * sizeof(double) +
                      (size_t)(threads * VEC + 2 * slab) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(channels / slab, batch);
  const T* xt = static_cast<const T*>(x);
  const float* st = static_cast<const float*>(scale);
  const float* bt = static_cast<const float*>(bias);
  T* yt = static_cast<T*>(y);
  switch (nv) {
#define GN_CASE(N)                                                     \
  case N:                                                              \
    groupnorm_silu_kernel<T, VEC, N><<<grid, threads, smem, stream>>>( \
        xt, st, bt, yt, hw, channels, cgs, slab, chunks, eps);         \
    break;
    GN_CASE(1)
    GN_CASE(2)
    GN_CASE(4)
    GN_CASE(8)
    GN_CASE(16)
#undef GN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (batch, hw, channels) contiguous, f32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); scale, bias: (channels,) f32.  groups divides channels.
// The plan: slab channels a block covers (whole groups, dividing
// channels), threads a block (a multiple of slab / vec, at most 512),
// vec elements a load (1, or 16 bytes' worth with 16-byte aligned x, y
// and slab rows), nv loads a thread holds (1, 2, 4, 8 or 16).
extern "C" int groupnorm_silu_launch(const void* x, const void* scale,
                                     const void* bias, void* y, int batch,
                                     int hw, int channels, int groups,
                                     float eps, int is_bf16, int slab,
                                     int threads, int vec, int nv,
                                     void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  if (batch <= 0 || batch > 65535 || hw <= 0 || channels <= 0 ||
      groups <= 0 || channels % groups != 0 || slab <= 0 ||
      channels % slab != 0 || slab % (channels / groups) != 0 ||
      threads < 1 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  if (vec != 1) {
    const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                            reinterpret_cast<uintptr_t>(y);
    if (vec * esize != 16 || slab % vec != 0 || align % 16 != 0 ||
        (channels * esize) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  }
  if (threads % (slab / vec) != 0) return (int)cudaErrorInvalidValue;
  const int cgs = channels / groups;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return vec == 1 ? launch_typed<__nv_bfloat16, 1>(
                          x, scale, bias, y, batch, hw, channels, cgs, eps,
                          slab, threads, nv, st)
                    : launch_typed<__nv_bfloat16, 8>(
                          x, scale, bias, y, batch, hw, channels, cgs, eps,
                          slab, threads, nv, st);
  }
  return vec == 1 ? launch_typed<float, 1>(x, scale, bias, y, batch, hw,
                                           channels, cgs, eps, slab,
                                           threads, nv, st)
                  : launch_typed<float, 4>(x, scale, bias, y, batch, hw,
                                           channels, cgs, eps, slab,
                                           threads, nv, st);
}
