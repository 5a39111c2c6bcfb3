// Flash-decode: one query token per sequence against a KV cache, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas, body _kernel): q (B,1,H,D) against caches
// (B,S,KV,D) with cur_len (B,) valid entries per row; positions
// >= cur_len, and with a window those < cur_len - window, are masked
// with the reference's finite -1e30; cache rows with no valid position
// are skipped and read nothing; online softmax with f32 m, l, acc and p
// kept in f32 for the PV product; output acc / max(l, 1e-30) in q's
// type.  q and the cache may differ in type: the serving path's default
// is f32 q over a bf16 cache.  22 calls per TinyLlama decode step, q
// (B,1,32,64) over caches (B,512,4,64), G = H/KV = 8; 9 per Zamba2
// step, q (B,1,32,80) over (B,512,32,80), G = 1; granite-34b's
// multi-query attention, q (B,1,48,128) over (B,512,1,128), G = 48; the
// VLM's cross decode, q (B,1,64,128) over whole (B,1601,8,128) caches.
// Like the Pallas kernel, which holds a group as one (G, D) tile, it
// takes any G that divides H.
//
// What bounds it.  Each valid cache row (k and v, D values each) is
// read once for the G query heads of its group: 4*G*D operations
// against 4*D bytes (bf16), ~8 operations per byte at G = 8, ~1 at
// G = 1 and ~48 at granite's G = 48.  At the serving path's sizes the
// valid cache is 1-2 MB, L2-resident when warm, so what is left is
// latency: the longest chain of dependent loads, products and barriers
// a block runs, and how many blocks run side by side.  The VLM's cross
// call reads 52 MB, more than the 50 MB L2: there the bound is the
// device memory's rate, and the kernel needs enough bytes in flight on
// every SM and a grid of whole waves.
//
// Two split kernels, chosen by a shape rule in the wrapper (ops.plan),
// then one combine kernel:
//
// decode_tc_kernel, tensor cores, for G > 8 and for G = 8 over rows of
// D = 128 (G * D >= 1024: qwen3, the VLM, granite, G = 9-96 in the card
// tests).
// - Per cache tile, scores^T = K_tile . Q^T (positions x heads) and
//   O^T += V^T . P^T (D x heads) on the tensor cores with f32
//   accumulation: cache positions are the M side in 16-row m-tiles, the
//   group's heads the N side in n-tiles of 8, so G = 8 wastes nothing.
// - f32 precision.  Over a bf16 cache the products are bf16
//   mma.sync m16n8k16: K and V are exact in bf16 and go in as they are
//   (ldmatrix, .trans for V^T: one instruction a 16 x 16 fragment, no
//   conversion), and each f32 operand (q, and p, which stays f32 until
//   here) is split into three bf16 parts, x = x1 + x2 + x3 (8 of its 24
//   bits each), so a product is three exact ones, small parts first
//   (a bf16 q is one part).  Over an f32 cache the products are TF32
//   m16n8k8 3xTF32 (hi + lo of each f32 operand), as flash_attention.cu
//   keeps them.  A bf16 m16n8k16 costs the tensor cores what a TF32
//   m16n8k8 does, for twice the depth.
// - A block is 4 warps over `hb` heads of one KV head (8 for G = 8, 16
//   beyond; ops.TC_BLOCK_HEADS): hb / 8 n-tile warps times 4 / (hb / 8)
//   row warps, so a tile holds 16 rows per row warp (64 at G = 8, 32
//   at hb = 16).  Each warp owns one n-tile of 8 heads and one m-tile of
//   16 rows of every tile, and runs its own online softmax over them:
//   the per-head max reduces over the 8 lanes of a column (3 shuffles),
//   l stays a per-lane partial sum until the end.  P's accumulator
//   layout (lane g, t: rows g, g+8, heads 2t, 2t+1) is not PV's B
//   layout (head g): 8 shuffles a tile move it inside the warp, so a
//   tile needs one barrier.  At the end the block merges its row warps'
//   (m, l, O) in shared memory.
// - Registers: O^T is D/16 m-tiles x 4 (32 at D = 128), the scores up
//   to 3 parts x 2 k-step parities x 4 (the parities are separate
//   accumulators, so no product waits on the one before it), so q does
//   not fit too: the block's q, split into its parts, sits in shared
//   memory in fragment order (one conflict-free 8-byte load a lane,
//   part and k-step), loaded before the block reads cur_len.
//   __launch_bounds__(128, 4) caps a thread at 128 registers (88-128
//   used, no spills), so registers never hold an SM below 4 blocks, and
//   the wrapper's residency (ops.plan: min(4, what shared memory
//   allows)) is the card's where shared memory binds, as at every
//   D = 128 shape, and a lower bound elsewhere.
// - A three-stage ring of tiles, 16-byte cp.async, two tiles in flight
//   while one is used; rows outside the block's valid rows are zero-
//   filled, not read.  Row strides (16-byte chunks: odd over a bf16
//   cache, where ldmatrix reads 8 rows at once; 2 mod 4 over f32) keep
//   every fragment load free of bank conflicts.  The VLM's cross call
//   holds 110,592 bytes a block (2 an SM, 64 KB in flight each);
//   granite's 64,512 (3 an SM).  One bulk copy (cp.async.bulk on an
//   mbarrier) a 256-byte row measured slower, 39.9-40.3 us against
//   26.7 for the VLM's cross call (PERF.md).
// - Splits of 16-row granules (one m-tile, `kGran`).  The valid range
//   [lo, hi) of a row is cut into granules and each split takes an
//   equal share (shares differ by at most one), so every block holds
//   valid rows.  splits = min(ceil(S / 64), SMs x resident / (B x KV x
//   head blocks)) (ops.plan): the grid is at most one wave of resident
//   blocks (the VLM's cross: 4 splits, 256 blocks in 264 places), and a
//   split holds at least 64 rows of a full cache (granite: 8 splits,
//   192 blocks), since at B = 1 more splits cost the combine more than
//   they save.
//
// decode_split_kernel, CUDA cores, for G < 8 and for G = 8 over narrower
// rows (Zamba2, deepseek, codeqwen, whisper at G = 1, minitron at G = 3,
// TinyLlama at G = 8, D = 64, whose dry-run cost is held at the f32
// rate; the tensor-core kernel measured 7.30 against 7.86 us there,
// PERF.md).
// - Split-K over the valid range, decided on the device.  The grid is
//   (splits, KV, B).  Each block reads cur_len[b] itself, computes the
//   valid range [lo, hi), and takes an equal share of the 64-row tiles
//   that overlap it (shares differ by at most one tile).  `splits`
//   depends on shapes only (ops.num_splits: a few blocks per SM, at most
//   ceil(S/64)).
// - Every warp busy: the 8 warps are position slices of 8 rows of each
//   tile, all G heads (at most 8) a warp.  For the scores 4 lanes share
//   a position, each summing a quarter of the D products, joined by
//   shuffles; for the PV product lane l holds output columns l + 32 j
//   (ceil(D/32) of them), p broadcast by shuffle.  Each warp runs its
//   own online softmax over its positions; at the end the block merges
//   its warps' (m, l, acc) in shared memory.  The heads a warp may hold
//   (HM: G rounded up to a power of two) are a template parameter, so a
//   lane keeps HM * ceil(D/32) accumulators and no more: at G = 1 the
//   kernel needs few registers and more blocks fit on an SM.
// - 16-byte cp.async loads into a two-stage ring of tiles in the cache's
//   own type; rows outside [lo, hi) are zero-filled, not read.  k rows
//   are stored at an odd stride of 16-byte chunks, so the score loop
//   has no bank conflicts.
//
// Both write, per head and split, the unnormalised acc (D) and m and l
// (f32) to a scratch buffer the wrapper allocates; a split with no valid
// row writes acc = 0, m = -1e30, l = 0.  decode_combine_kernel, launched
// right after on the same stream, merges the splits per (b, head) and
// writes acc / max(l, 1e-30) in q's type.  The host never reads cur_len, so the serving path stays
// free of syncs and can be captured in a CUDA graph.
//
// The finite -1e30 mask: a masked position gets p = 0 explicitly,
// never exp(-1e30 - m), so a warp or split whose positions are all
// masked contributes l = 0, acc = 0, and a row with cur_len = 0 gives 0.
//
// The block entry (decode_attention_block_launch) runs the same passes
// over one block of a cache split along its sequence axis (a
// sequence-sharded cache, one block a rank): the block's rows sit at
// global positions [offset, offset + S), cur_len and the window stay
// global, and an optional lo_len (B,) raises each row's first valid
// position (the slice-reads window).  A split kernel's block reads only
// the rows that are valid in the whole cache.  The combine writes the
// block's o in f32 and lse = m + log(l); the caller merges blocks by
// log-sum-exp (models/layers.py).  A block with no valid row gives
// o = 0 and lse = -inf.
//
// Measured: PERF.md section 6 (chip_smoke.py, tools/time_attention.py).
//
// C interface (route: nvcc -shared, loaded with ctypes): device pointers
// and the stream arrive as void*, both kernels are launched on that
// stream, and the function returns cudaGetLastError() so the caller can
// raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBS = 64;        // cache positions per tile, CUDA-core kernel
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 8;       // heads a CUDA-core block holds
constexpr int kTcWarps = 4;    // the tensor-core kernel's block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcMinBlocks = 4;
constexpr int kMaxHb = 16;     // heads a tensor-core block holds, at most
constexpr int kStages = 3;     // tiles in the tensor-core kernel's ring
constexpr int kGran = 16;      // rows of an m-tile: its split granule
constexpr int kCombineWarps = 4;
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory layout of one stage of the CUDA-core ring for cache
// type TC: kBS k rows at an odd stride of 16-byte chunks, then kBS v
// rows.
template <typename TC, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(TC);   // elements per chunk
  static constexpr int kChunks = D / kVec;       // chunks per row
  static constexpr int kKStride = kChunks | 1;   // k row stride, chunks
  static constexpr int kStage = kBS * (kKStride + kChunks) * kVec;
  static constexpr size_t kRingBytes = 2 * kStage * sizeof(TC);
  static_assert(D % kVec == 0, "a row must be whole 16-byte chunks");
};

// The tensor-core kernel's layout for cache type TC, head size D and q
// in f32 (QF32) or bf16: its products (bf16 m16n8k16 over a bf16 cache,
// TF32 m16n8k8 over f32), the row stride of its ring in 16-byte chunks,
// q's parts, and its shared memory for `hb` heads a block (ops.tc_smem
// mirrors it).
template <typename TC, int D, bool QF32>
struct TcLayout {
  static constexpr bool kBF = sizeof(TC) == 2;
  static constexpr int kVec = 16 / sizeof(TC);
  static constexpr int kChunks = D / kVec;
  // odd over a bf16 cache (ldmatrix reads 8 rows of 16 bytes at once),
  // 2 mod 4 over f32 (8-byte fragment loads, 4 rows of 32 bytes)
  static constexpr int kRS =
      kBF ? (kChunks | 1) : kChunks + ((2 - kChunks) % 4 + 4) % 4;
  // q's parts: over a bf16 cache 3 bf16 parts of an f32 q (1 of a bf16
  // q), 2 bytes each; over f32 TF32 hi and lo (hi alone), 4 bytes each
  static constexpr int kQParts = kBF ? (QF32 ? 3 : 1) : (QF32 ? 2 : 1);
  static constexpr int kKStep = kBF ? 16 : 8;  // d a score product takes
  static constexpr int kNK = D / kKStep;       // k-steps of the scores
  static constexpr int kNM = D / 16;           // m-tiles of O^T
  static_assert(D % 16 == 0, "head sizes are multiples of 16");
  // uint2 fragments of one q part: (n-tile, k-step, lane)
  __host__ __device__ static int q_frags(int hb) {
    return hb / 8 * kNK * 32;
  }
  __host__ __device__ static size_t q_bytes(int hb) {
    return sizeof(uint2) * q_frags(hb) * kQParts;
  }
  static size_t smem(int hb) {
    const int rows = kGran * (kTcWarps / (hb / 8));
    const size_t ring = (size_t)16 * kStages * rows * 2 * kRS;
    const size_t merge = sizeof(float) * kTcWarps * 8 * (D + 8 + 2);
    return q_bytes(hb) + (ring > merge ? ring : merge);
  }
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

// Two neighbouring elements as f32.
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties
// away from zero), in two integer operations (flash_attention.cu).
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value (exact: hi alone, lo = 0).
template <bool kExact>
__device__ __forceinline__ void to_tf32(float x, uint32_t& hi, uint32_t& lo) {
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

// d += a * b: one m16n8k16 bf16 product, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory, lane l giving the address
// of row l % 8 of matrix l / 8; transposed (.trans) or not.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// x = p[0] + p[1] + p[2], three bf16 values (8 bits of x's 24 each, so
// the sum is x to f32's precision; exact when NP = 1 and x is bf16).
template <int NP>
__device__ __forceinline__ void to_bf16_parts(float x,
                                              __nv_bfloat16 (&p)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(p[i]);
  }
}
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  const __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
// Over the 8 lanes of an accumulator column (lanes t, t+4, ..., t+28).
__device__ __forceinline__ float column_max(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ float column_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Scratch row of (b, head, split): acc[0..D), then m, then l.
template <int D>
__device__ __forceinline__ float* part_row(float* part, int bh, int split,
                                           int splits) {
  return part + ((size_t)bh * splits + split) * (D + 2);
}

// The valid rows [lo, hi) of batch row b in a block at `offset`, and
// this split's share [u0, u1) of the `gran`-row units that overlap
// them.  Returns false when the share is empty.
__device__ __forceinline__ bool valid_share(
    const int* __restrict__ cur_len, const int* __restrict__ lo_len, int b,
    int S, int window, int offset, int gran, int split, int splits, int& lo,
    int& hi, int& u0, int& u1) {
  const int cur = cur_len[b];
  int glo = window ? cur - window : 0;
  if (lo_len) glo = max(glo, lo_len[b]);
  hi = min(cur - offset, S);
  lo = max(glo - offset, 0);
  const int u_lo = lo / gran;
  const int n = hi > lo ? (hi + gran - 1) / gran - u_lo : 0;  // valid units
  const int share = n / splits, extra = n % splits;  // the first `extra`
  u0 = u_lo + split * share + min(split, extra);     // splits take one
  u1 = u0 + share + (split < extra);                 // more
  return u0 < u1;
}

// An empty split: acc = 0, m = -1e30 and l = 0 for its heads.
template <int D>
__device__ __forceinline__ void write_empty(float* part, int bh0, int heads,
                                            int split, int splits, int tid,
                                            int threads) {
  for (int e = tid; e < heads * (D + 2); e += threads) {
    const int h = e / (D + 2), c = e % (D + 2);
    part_row<D>(part, bh0 + h, split, splits)[c] = c == D ? kNegInf : 0.f;
  }
}

// ---- the tensor-core split kernel ------------------------------------
//
// Grid (splits, KV * ceil(G / hb), B), 4 warps a block; warp w owns
// n-tile w % (hb/8) of the block's heads and row slice w / (hb/8) of
// each tile.  q is f32 (QF32) or bf16.
template <typename TC, int D, bool QF32>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
    decode_tc_kernel(const void* __restrict__ q, const TC* __restrict__ kc,
                     const TC* __restrict__ vc,
                     const int* __restrict__ cur_len,
                     const int* __restrict__ lo_len,
                     float* __restrict__ part, int S, int H, int KV,
                     int window, int offset, float scale, int splits,
                     int hb) {
  using L = TcLayout<TC, D, QF32>;
  constexpr bool BF = L::kBF;
  constexpr int VEC = L::kVec, NC = L::kChunks, RS = L::kRS * VEC;
  constexpr int NK = L::kNK, NM = L::kNM, QP = L::kQParts;
  extern __shared__ __align__(16) unsigned char smem[];

  const int G = H / KV, chunks = (G + hb - 1) / hb;
  const int wh = hb >> 3, TR = kGran * (kTcWarps / wh);  // rows a tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / chunks, hc = blockIdx.y % chunks;
  const int Gb = min(hb, G - hc * hb);                 // the block's heads
  const int bh0 = b * H + kvh * G + hc * hb;           // its first (b, h)

  // q's (head, d pair)s of the block, 16 heads at most: loaded before
  // the block waits on cur_len, so the loads overlap
  constexpr int kQIt = kMaxHb * (D / 2) / kTcThreads;
  float2 qr[kQIt];
#pragma unroll
  for (int k = 0; k < kQIt; ++k) {
    const int e = tid + k * kTcThreads, h = e / (D / 2);
    const size_t off = (size_t)(bh0 + h) * D + 2 * (e % (D / 2));
    qr[k] = make_float2(0.f, 0.f);
    if (e < hb * D / 2 && h < Gb)
      qr[k] = QF32 ? *reinterpret_cast<const float2*>(
                         static_cast<const float*>(q) + off)
                   : __bfloat1622float2(
                         *reinterpret_cast<const __nv_bfloat162*>(
                             static_cast<const __nv_bfloat16*>(q) + off));
  }

  int lo, hi, u0, u1;
  if (!valid_share(cur_len, lo_len, b, S, window, offset, kGran, split,
                   splits, lo, hi, u0, u1)) {
    write_empty<D>(part, bh0, Gb, split, splits, tid, kTcThreads);
    return;
  }
  const int r0 = u0 * kGran;                            // first row
  const int r_lo = max(lo, r0), r_hi = min(hi, u1 * kGran);  // valid rows
  const int ntiles = ((u1 - u0) * kGran + TR - 1) / TR;

  uint2* Q = reinterpret_cast<uint2*>(smem);  // [QP][hb/8][NK][32]
  const int qf = L::q_frags(hb);
  TC* ring = reinterpret_cast<TC*>(smem + L::q_bytes(hb));
  const int stage = TR * 2 * RS;              // k rows, then v rows
  const size_t row = (size_t)KV * D;
  const TC* kb = kc + (size_t)b * S * row + (size_t)kvh * D;
  const TC* vb = vc + (size_t)b * S * row + (size_t)kvh * D;

  auto load = [&](int i) {  // tile i into stage i % kStages
    TC* Ks = ring + (i % kStages) * stage;
    TC* Vs = Ks + TR * RS;
    const int base = r0 + i * TR;
    for (int e = tid; e < TR * NC; e += kTcThreads) {
      const int r = e / NC, c = e % NC, pos = base + r;
      const bool in = pos >= r_lo && pos < r_hi;
      const size_t off = (size_t)(in ? pos : r_lo) * row + c * VEC;
      cp_async16(Ks + r * RS + c * VEC, kb + off, in);
      cp_async16(Vs + r * RS + c * VEC, vb + off, in);
    }
  };
  load(0);
  cp_async_commit();
  if (ntiles > 1) load(1);
  cp_async_commit();

  // q in fragment order, the B operand of the scores: entry (n-tile h/8,
  // k-step, lane 4 (h%8) + t) of each part.  bf16 products (k-step 16):
  // .x holds d = 2t, 2t+1 of the k-step, .y d = 2t+8, 2t+9.  TF32 (k-step
  // 8): .x d = 2t, .y d = 2t+1 (the d axis renumbered as in
  // flash_attention.cu: d = 2t, 2t+1 of a k-step are its k-indices t,
  // t+4)
#pragma unroll
  for (int k = 0; k < kQIt; ++k) {
    const int e = tid + k * kTcThreads, h = e / (D / 2);
    const int d = 2 * (e % (D / 2));
    if (e >= hb * D / 2) break;
    const int frag = (((h >> 3) * NK + d / L::kKStep) << 5) |
                     ((h & 7) << 2) | ((d & 7) >> 1);
    if constexpr (BF) {
      __nv_bfloat16 x0[QP], x1[QP];
      to_bf16_parts<QP>(qr[k].x, x0);
      to_bf16_parts<QP>(qr[k].y, x1);
      uint32_t* words = reinterpret_cast<uint32_t*>(Q);
#pragma unroll
      for (int pi = 0; pi < QP; ++pi)
        words[2 * (pi * qf + frag) + ((d >> 3) & 1)] = pack_bf16(x0[pi], x1[pi]);
    } else {
      uint32_t h0, l0, h1, l1;
      to_tf32<!QF32>(qr[k].x, h0, l0);
      to_tf32<!QF32>(qr[k].y, h1, l1);
      Q[frag] = make_uint2(h0, h1);
      if constexpr (QF32) Q[qf + frag] = make_uint2(l0, l1);
    }
  }

  const int nt = warp % wh, wrow = warp / wh;
  const bool active = nt * 8 < Gb;
  const uint2* qw = Q + nt * NK * 32 + lane;  // the warp's n-tile
  // P from the accumulator layout (lane g, t: rows g, g+8, heads 2t,
  // 2t+1) to PV's B operand (head g): lane (g, t) wants, for bf16
  // products, p of rows 2t, 2t+1, 2t+8, 2t+9, held by lanes 8t + g/2
  // and 8t + 4 + g/2; for TF32, rows t, t+4, 8+t, 12+t, held by lanes
  // 4t + g/2 and 4(t+4) + g/2; in the register of head parity g%2
  const int srcA = BF ? 8 * t + (g >> 1) : 4 * t + (g >> 1);
  const int srcB = srcA + (BF ? 4 : 16);
  const bool odd = g & 1;

  // lane's heads 2t, 2t+1 of its n-tile: running max, partial sum, and
  // O^T (m-tile i: head 2t + j at [j] and [2 + j]; d = 16i + g and + 8
  // for bf16 products, 16i + 2g and + 1 for TF32)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, o[NM][4];
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[i][c] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<1>();
    __syncthreads();  // tile i (and q) visible; tile i-1's stage free
    if (i + 2 < ntiles) load(i + 2);
    cp_async_commit();
    const int rb = r0 + i * TR + kGran * wrow;  // the warp's first row
    if (!active || rb >= r_hi || rb + kGran <= r_lo) continue;  // uniform
    const TC* Ks = ring + (i % kStages) * stage + kGran * wrow * RS;
    const TC* Vs = Ks + TR * RS;

    // scores^T = K . q^T, the products into accumulators by q part (and,
    // over an f32 cache, K's lo) and k-step parity
    constexpr int NS = QP + !BF;
    float sp[NS][2][4] = {};
    if constexpr (BF) {
      // a: ldmatrix of rows g, g+8 at d = 16kk + 2t (+8): lanes 0-7 give
      // rows 0-7, 8-15 rows 8-15, 16-31 the same at d + 8
      const unsigned ka = smem_u32(Ks + ((lane & 7) + (lane & 8)) * RS +
                                   ((lane >> 4) << 3));
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, ka + kk * 32);
#pragma unroll
        for (int pi = QP - 1; pi >= 0; --pi) {
          const uint2 bq = qw[pi * qf + kk * 32];
          const uint32_t bb[2] = {bq.x, bq.y};
          mma_bf16(sp[pi][kk & 1], a, bb);
        }
      }
    } else {
      // a = K rows g, g+8 at d = 8kk + 2t, +1, split hi + lo
      const TC* k0 = Ks + g * RS + 2 * t;
      const TC* k1 = k0 + 8 * RS;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const float2 x0 = pair_f32(k0 + 8 * kk), x1 = pair_f32(k1 + 8 * kk);
        uint32_t ah[4], al[4];
        to_tf32<false>(x0.x, ah[0], al[0]);
        to_tf32<false>(x1.x, ah[1], al[1]);
        to_tf32<false>(x0.y, ah[2], al[2]);
        to_tf32<false>(x1.y, ah[3], al[3]);
        const uint2 bq = qw[kk * 32];
        const uint32_t bh[2] = {bq.x, bq.y};
        if constexpr (QF32) {
          const uint2 lq = qw[qf + kk * 32];
          const uint32_t bl[2] = {lq.x, lq.y};
          mma(sp[1][kk & 1], ah, bl);
        }
        mma(sp[QP][kk & 1], al, bh);
        mma(sp[0][kk & 1], ah, bh);
      }
    }

    // online softmax of heads 2t + j over rows g, g+8
    const int p0 = rb + g, p1 = p0 + 8;
    const bool v0 = p0 >= r_lo && p0 < r_hi, v1 = p1 >= r_lo && p1 < r_hi;
    float pr[4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float sc[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int pi = NS - 1; pi >= 0; --pi)  // the small parts first
          sc[r] += sp[pi][0][2 * r + j] + sp[pi][1][2 * r + j];
      const float a = v0 ? sc[0] * scale : kNegInf;
      const float c = v1 ? sc[1] * scale : kNegInf;
      const float mn = fmaxf(m[j], column_max(fmaxf(a, c)));
      const float alpha = expf(m[j] - mn);
      pr[j] = v0 ? expf(a - mn) : 0.f;
      pr[2 + j] = v1 ? expf(c - mn) : 0.f;
      l[j] = fmaf(l[j], alpha, pr[j] + pr[2 + j]);
      m[j] = mn;
#pragma unroll
      for (int i2 = 0; i2 < NM; ++i2) {
        o[i2][j] *= alpha;
        o[i2][2 + j] *= alpha;
      }
    }

    float xa[4], xb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      xa[c] = __shfl_sync(kFull, pr[c], srcA);
      xb[c] = __shfl_sync(kFull, pr[c], srcB);
    }

    if constexpr (BF) {
      // O^T += V^T . P^T, p in 3 bf16 parts: b = p of rows 2t, 2t+1 (.x)
      // and 2t+8, 2t+9 (.y) for head g; a = V^T by ldmatrix.trans, lanes
      // 0-7 rows 0-7 at d = 16i, 8-15 the same at d + 8, 16-31 rows 8-15
      __nv_bfloat16 q0[3], q1[3], q8[3], q9[3];
      to_bf16_parts<3>(odd ? xa[1] : xa[0], q0);
      to_bf16_parts<3>(odd ? xb[1] : xb[0], q1);
      to_bf16_parts<3>(odd ? xa[3] : xa[2], q8);
      to_bf16_parts<3>(odd ? xb[3] : xb[2], q9);
      uint32_t bp[3][2];
#pragma unroll
      for (int pi = 0; pi < 3; ++pi) {
        bp[pi][0] = pack_bf16(q0[pi], q1[pi]);
        bp[pi][1] = pack_bf16(q8[pi], q9[pi]);
      }
      const unsigned va = smem_u32(Vs + ((lane & 7) + ((lane >> 4) << 3)) * RS +
                                   (lane & 8));
#pragma unroll
      for (int i2 = 0; i2 < NM; ++i2) {
        uint32_t a[4];
        ldsm_x4_t(a, va + i2 * 32);
        mma_bf16(o[i2], a, bp[2]);
        mma_bf16(o[i2], a, bp[1]);
        mma_bf16(o[i2], a, bp[0]);
      }
    } else {
      // O^T += V^T . P^T: a = V rows 8kk + t (+4) at d = 16i + 2g, +1
      const TC* vt = Vs + t * RS + 2 * g;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ph[2], pl[2];
        to_tf32<false>(odd ? xa[2 * kk + 1] : xa[2 * kk], ph[0], pl[0]);
        to_tf32<false>(odd ? xb[2 * kk + 1] : xb[2 * kk], ph[1], pl[1]);
        const TC* va = vt + 8 * kk * RS;
        const TC* vc4 = va + 4 * RS;
#pragma unroll
        for (int i2 = 0; i2 < NM; ++i2) {
          const float2 y0 = pair_f32(va + 16 * i2);
          const float2 y1 = pair_f32(vc4 + 16 * i2);
          uint32_t ah[4], al[4];
          to_tf32<false>(y0.x, ah[0], al[0]);
          to_tf32<false>(y0.y, ah[1], al[1]);
          to_tf32<false>(y1.x, ah[2], al[2]);
          to_tf32<false>(y1.y, ah[3], al[3]);
          mma(o[i2], ah, pl);
          mma(o[i2], al, ph);
          mma(o[i2], ah, ph);
        }
      }
    }
  }

  // merge the row warps of each n-tile; the ring is free now and holds
  // each warp's m, l and O for its 8 heads
  cp_async_wait<0>();
  __syncthreads();
  float* Os = reinterpret_cast<float*>(ring);   // [warps * 8][D + 8]
  float* Ms = Os + kTcWarps * 8 * (D + 8);      // [warps * 8]
  float* Ls = Ms + kTcWarps * 8;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int wh_j = warp * 8 + 2 * t + j;
    const float lsum = column_sum(l[j]);
    if (g == 0) {
      Ms[wh_j] = m[j];
      Ls[wh_j] = lsum;
    }
    float* orow = Os + wh_j * (D + 8);
#pragma unroll
    for (int i2 = 0; i2 < NM; ++i2) {
      if constexpr (BF) {
        orow[16 * i2 + g] = o[i2][j];
        orow[16 * i2 + g + 8] = o[i2][2 + j];
      } else {
        *reinterpret_cast<float2*>(orow + 16 * i2 + 2 * g) =
            make_float2(o[i2][j], o[i2][2 + j]);
      }
    }
  }
  __syncthreads();
  const int wr = kTcWarps / wh;
  // head h's slot in row warp w: (w * wh + h / 8) * 8 + h % 8
  if (tid < Gb) {  // per head: the block's m and l, each row warp's weight
    float M = kNegInf, Lsum = 0.f;
    for (int w = 0; w < wr; ++w) M = fmaxf(M, Ms[w * hb + tid]);
    for (int w = 0; w < wr; ++w) {
      const int s = w * hb + tid;
      const float a = expf(Ms[s] - M);
      Lsum = fmaf(Ls[s], a, Lsum);
      Ms[s] = a;  // read back only by this thread until the barrier
    }
    float* out = part_row<D>(part, bh0 + tid, split, splits);
    out[D] = M;
    out[D + 1] = Lsum;
  }
  __syncthreads();
  for (int e = tid; e < Gb * D; e += kTcThreads) {
    const int h = e / D, d = e % D;
    float A = 0.f;
    for (int w = 0; w < wr; ++w) {
      const int s = w * hb + h;
      A = fmaf(Os[s * (D + 8) + d], Ms[s], A);
    }
    part_row<D>(part, bh0 + h, split, splits)[d] = A;
  }
}

// ---- the CUDA-core split kernel (G <= 8) ------------------------------
//
// Grid (splits, KV, B), 8 warps a block, each a position slice of 8 rows
// of every tile and all G heads; HM = G rounded up to a power of two; q
// is f32 (q_bf16 = 0) or bf16, read once into shared memory.  Registers
// are budgeted for 4 blocks an SM with one head a warp, or two over a
// bf16 cache (G = 1 is Zamba2's: its 512 blocks at B = 8 then run in one
// wave), and for 2 blocks with more heads over a bf16 cache; beyond one
// head an f32 cache's wider chunks get the compiler's full budget, so no
// instantiation spills.
template <typename TC, int D, int HM>
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
  constexpr int PW = kBS / kWarps;  // positions a warp holds in a tile
  constexpr int R = 32 / PW;        // lanes per position in the scores
  constexpr int C = (D + 31) / 32;  // a lane's columns: lane + 32 j
  extern __shared__ __align__(16) unsigned char smem[];

  const int G = H / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int bh0 = b * H + kvh * G;  // the block's first (b, h)

  // q's G*D values, 4 a thread per step, loaded before the block waits
  // on cur_len so the two loads overlap
  constexpr int kQSteps = (HM * D / 4 + kThreads - 1) / kThreads;
  float4 qr[kQSteps];
#pragma unroll
  for (int k = 0; k < kQSteps; ++k) {
    const int e4 = tid + k * kThreads;
    if (e4 < G * D / 4) {
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

  int lo, hi, t0, t1;  // valid rows [lo, hi), this block's tiles [t0, t1)
  if (!valid_share(cur_len, lo_len, b, S, window, offset, kBS, split,
                   splits, lo, hi, t0, t1)) {
    write_empty<D>(part, bh0, G, split, splits, tid, kThreads);
    return;
  }

  float* Qs = reinterpret_cast<float*>(smem);                     // [G][D]
  TC* ring = reinterpret_cast<TC*>(smem + sizeof(float) * G * D);  // 2 stages
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
    if (e4 < G * D / 4) reinterpret_cast<float4*>(Qs)[e4] = qr[k];
  }

  const int pi = lane % PW, r = lane / PW;

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
    const int p_w = warp * PW;  // the warp's first row
    const int pos = t * kBS + p_w + pi;
    const bool valid = pos >= lo && pos < hi;

    // scores: lanes r of position pi each sum chunks r, r+R, ...  The
    // shuffles below run for all HM heads, outside any branch the
    // compiler cannot prove uniform (a shuffle there costs a collective
    // loop); only the arithmetic of heads past G is skipped.
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
        if (h < G) {
          const float* qg = Qs + h * D + c * VEC;
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

    // online softmax over the warp's PW positions, per head
    float p[HM];
#pragma unroll
    for (int h = 0; h < HM; ++h) {
#pragma unroll
      for (int o = PW; o < 32; o <<= 1)
        s[h] += __shfl_xor_sync(kFull, s[h], o);
      const float sc = valid ? s[h] * scale : kNegInf;
      float mx = sc;
#pragma unroll
      for (int o = 1; o < PW; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
      const float m_new = fmaxf(m[h], mx);
      const float alpha = expf(m[h] - m_new);
      p[h] = valid ? expf(sc - m_new) : 0.f;
      float sum = p[h];
#pragma unroll
      for (int o = 1; o < PW; o <<= 1)
        sum += __shfl_xor_sync(kFull, sum, o);
      l[h] = l[h] * alpha + sum;
      m[h] = m_new;
#pragma unroll
      for (int j = 0; j < C; ++j) acc[h][j] *= alpha;
    }

    // PV: lane l holds columns l + 32 j; p of position i from lane i
    const TC* Vw = Vs + p_w * D;
#pragma unroll 4
    for (int i = 0; i < PW; ++i) {
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
    __syncthreads();  // stage st consumed before it is loaded again
  }

  // merge the position-slice warps; the ring is free now and holds each
  // warp's m, l and acc
  float* Mw = reinterpret_cast<float*>(ring);  // [kWarps][HM]
  float* Lw = Mw + kWarps * HM;
  float* Aw = Lw + kWarps * HM;                // [kWarps][HM][D]
#pragma unroll
  for (int h = 0; h < HM; ++h) {
    if (h < G) {
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
  if (tid < G) {  // per head: the block's m and l, each warp's weight
    float M = kNegInf, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, Mw[w * HM + tid]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int wh = w * HM + tid;
      const float a = expf(Mw[wh] - M);
      L = fmaf(Lw[wh], a, L);
      Mw[wh] = a;  // read back only by this thread until the barrier
    }
    float* out = part_row<D>(part, bh0 + tid, split, splits);
    out[D] = M;
    out[D + 1] = L;
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    const int h = e / D, d = e % D;
    float A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int wh = w * HM + h;
      A = fmaf(Aw[wh * D + d], Mw[wh], A);
    }
    part_row<D>(part, bh0 + h, split, splits)[d] = A;
  }
}

// One warp per (b, head), 4 a block: merge the splits' (m, l, acc) and
// normalise.  Splits are taken 32 at a time (lane s holds split s's m
// and l) with a running max; the acc of the first kAhead splits of each
// 32 is loaded beside their m and l, so a call with up to kAhead splits
// waits on memory once, and the rest are unrolled so several loads are
// in flight.  An empty split (m = -1e30, l = 0, acc = 0) weighs 0.
template <typename TQ, int D>
__global__ void __launch_bounds__(32 * kCombineWarps)
    decode_combine_kernel(const float* __restrict__ part, TQ* __restrict__ o,
                          float* __restrict__ lse, int rows, int splits) {
  constexpr int C = (D + 31) / 32, kAhead = 16;
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);
  if (bh >= rows) return;  // uniform across the warp
  const float* P = part + (size_t)bh * splits * (D + 2);
  float M = kNegInf, L = 0.f, acc[C];
#pragma unroll
  for (int j = 0; j < C; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < splits; s0 += 32) {
    const int cnt = min(32, splits - s0);
    float va[kAhead][C];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j)
        va[i][j] = i < cnt && lane + 32 * j < D
                       ? P[(s0 + i) * (D + 2) + lane + 32 * j]
                       : 0.f;
    float ms = kNegInf, ls = 0.f;
    if (lane < cnt) {
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
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const float wi = __shfl_sync(kFull, w, i);
#pragma unroll
      for (int j = 0; j < C; ++j) acc[j] = fmaf(wi, va[i][j], acc[j]);
    }
#pragma unroll 8
    for (int i = kAhead; i < cnt; ++i) {
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
// null.  `offset` is the global position of the caches' row 0; `hb` the
// heads a tensor-core block holds, 0 for the CUDA-core kernel.
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
  int splits, hb;
  cudaStream_t stream;
};

// Lift the kernel's dynamic shared memory limit where `smem` needs it,
// and ask for the largest shared-memory carve-out (the kernels read
// their tiles through shared memory, not L1).
template <typename K>
int set_smem(K* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

template <typename TC, int D, bool QF32>
int launch_tc(const Args& a) {
  const size_t smem = TcLayout<TC, D, QF32>::smem(a.hb);
  auto* kernel = decode_tc_kernel<TC, D, QF32>;
  if (const int rc = set_smem(kernel, smem)) return rc;
  const int chunks = (a.H / a.KV + a.hb - 1) / a.hb;
  const dim3 grid(a.splits, a.KV * chunks, a.B);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      a.q, static_cast<const TC*>(a.kc), static_cast<const TC*>(a.vc), a.cur,
      a.lo, a.part, a.S, a.H, a.KV, a.window, a.offset, a.scale, a.splits,
      a.hb);
  return (int)cudaGetLastError();
}

template <typename TC, int D, int HM>
int launch_split(const Args& a) {
  const int G = a.H / a.KV;
  const size_t merge = sizeof(float) * kWarps * HM * (D + 2);
  const size_t ring = Tile<TC, D>::kRingBytes;
  const size_t smem = sizeof(float) * G * D + (ring > merge ? ring : merge);
  auto* kernel = decode_split_kernel<TC, D, HM>;
  if (const int rc = set_smem(kernel, smem)) return rc;
  const dim3 grid(a.splits, a.KV, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.q, a.q_bf16, static_cast<const TC*>(a.kc),
      static_cast<const TC*>(a.vc), a.cur, a.lo, a.part, a.S, a.H, a.KV,
      a.window, a.offset, a.scale, a.splits);
  return (int)cudaGetLastError();
}

// TO: the output's type (q's for decode_attention_launch, f32 for the
// block entry).  The split kernel is the wrapper's choice (a.hb): the
// tensor-core kernel, q's type a template parameter; or the CUDA-core
// kernel at HM = G rounded up to a power of two (G <= 8).
template <typename TO, typename TC, int D>
int launch_typed(const Args& a) {
  const int G = a.H / a.KV;
  int rc;
  if (a.hb)
    rc = a.q_bf16 ? launch_tc<TC, D, false>(a) : launch_tc<TC, D, true>(a);
  else if (G == 1)
    rc = launch_split<TC, D, 1>(a);
  else if (G == 2)
    rc = launch_split<TC, D, 2>(a);
  else if (G <= 4)
    rc = launch_split<TC, D, 4>(a);
  else
    rc = launch_split<TC, D, 8>(a);
  if (rc != 0) return rc;
  const int rows = a.B * a.H;
  decode_combine_kernel<TO, D>
      <<<(rows + kCombineWarps - 1) / kCombineWarps, 32 * kCombineWarps, 0,
         a.stream>>>(a.part, static_cast<TO*>(a.o), a.lse, rows, a.splits);
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

// hb: 8 or 16 heads a tensor-core block (1 or 2 n-tile warps), or 0
// for the CUDA-core kernel, which holds at most 8.
bool bad_shape(int H, int KV, int splits, int hb, int q_dtype) {
  if (KV < 1 || H % KV != 0 || splits < 1 || (q_dtype != 0 && q_dtype != 1))
    return true;
  const int G = H / KV;
  if (hb == 0) return G > kMaxG;
  return (hb != 8 && hb != kMaxHb) ||
         (long long)KV * ((G + hb - 1) / hb) > 65535;
}

template <typename TC, int D, bool QF32>
int occupancy(int hb, int* smem, int* blocks) {
  const size_t bytes = TcLayout<TC, D, QF32>::smem(hb);
  auto* kernel = decode_tc_kernel<TC, D, QF32>;
  if (const int rc = set_smem(kernel, bytes)) return rc;
  *smem = (int)bytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kTcThreads, bytes);
}

template <typename TC, bool QF32>
int occupancy_dim(int D, int hb, int* smem, int* blocks) {
  switch (D) {
    case 32:
      return occupancy<TC, 32, QF32>(hb, smem, blocks);
    case 64:
      return occupancy<TC, 64, QF32>(hb, smem, blocks);
    case 80:
      return occupancy<TC, 80, QF32>(hb, smem, blocks);
    case 128:
      return occupancy<TC, 128, QF32>(hb, smem, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B,1,H,D) contiguous; kc, vc: (B,S,KV,D) contiguous, one type,
// 16-byte aligned; cur_len: (B,) int32; part: f32 scratch of
// B*H*splits*(D+2) values.  dtype codes: 0 = float32, 1 = bfloat16, for
// q (and o) and for the caches separately.  hb: the heads a tensor-core
// block holds (grid (splits, KV * ceil(G/hb), B)), or 0 for the
// CUDA-core kernel (grid (splits, KV, B), G <= 8).  Launches the split
// kernel, then the combine kernel, on `stream`.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* cur_len,
                                       void* part, void* o, int B, int S,
                                       int H, int KV, int D, int window,
                                       float scale, int splits, int hb,
                                       int q_dtype, int c_dtype,
                                       void* stream) {
  if (bad_shape(H, KV, splits, hb, q_dtype)) return (int)cudaErrorInvalidValue;
  const Args a{q, q_dtype, kc, vc, static_cast<const int*>(cur_len), nullptr,
               static_cast<float*>(part), o, nullptr, B, S, H, KV, window,
               0, scale, splits, hb, static_cast<cudaStream_t>(stream)};
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
    int KV, int D, int window, int offset, float scale, int splits, int hb,
    int q_dtype, int c_dtype, void* stream) {
  if (bad_shape(H, KV, splits, hb, q_dtype) || offset < 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, q_dtype, kc, vc, static_cast<const int*>(cur_len),
               static_cast<const int*>(lo_len), static_cast<float*>(part), o,
               static_cast<float*>(lse), B, S, H, KV, window, offset, scale,
               splits, hb, static_cast<cudaStream_t>(stream)};
  return launch_cache<float>(a, D, c_dtype);
}

// The tensor-core kernel's shared memory a block (*smem) and the blocks
// an SM holds at it (*blocks, cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// for head size D, the dtype codes above and hb heads a block: what the
// wrapper's plan assumes, read from the card.
extern "C" int decode_attention_tc_occupancy(int D, int c_dtype, int q_dtype,
                                             int hb, int* smem, int* blocks) {
  if (hb != 8 && hb != kMaxHb) return (int)cudaErrorInvalidValue;
  if (c_dtype == 0)
    return q_dtype == 0 ? occupancy_dim<float, true>(D, hb, smem, blocks)
                        : occupancy_dim<float, false>(D, hb, smem, blocks);
  if (c_dtype == 1)
    return q_dtype == 0
               ? occupancy_dim<__nv_bfloat16, true>(D, hb, smem, blocks)
               : occupancy_dim<__nv_bfloat16, false>(D, hb, smem, blocks);
  return (int)cudaErrorInvalidValue;
}
