"""Wrapper for flash-decode attention.

A CPU tensor goes to the plain version (``ref.decode_attention_ref``);
a CUDA tensor launches the kernels of ``csrc/decode_attention.cu`` or
raises: a split pass over the valid cache, then a combine pass.  The
split pass is one of two kernels, chosen by a rule on the shapes alone
(``tensor_path``): the tensor-core kernel for groups of more than 8
query heads and for 8 over rows of 128, the CUDA-core kernel for the
rest.  ``plan`` gives each call's kernel, grid and split count, from
shapes alone: the host never reads cur_len.  Any group size G = H / KV
runs, as in the Pallas kernel.  q and the cache may differ in type
(float32 q over a bfloat16 cache is the serving path's default).
``launches`` counts wrapper calls that launched the kernels, one per
call, so a run can show that its path went through them.

``decode_attention_block`` runs the same kernels over one block of a
cache split along its sequence axis (each rank's block of a
sequence-sharded cache, ``models/layers.py``): the block's rows sit at
global positions ``offset`` on, ``cur_len`` and the window stay global,
and it returns the block's float32 output with the log-sum-exp of its
scores, which ``ref.lse_combine`` (or the ranks' all-reduce) merges.
``launches_block`` counts its launches.  There is no
gradient: under grad mode a CUDA or meta input that needs one raises.
A meta tensor gets the output's shape and type, no arithmetic
(``kernels.meta_call``); ``cost`` is a call's work.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import (BF16_OPS_PER_S, F32_OPS_PER_S, KernelCost,
                                 build, launch, meta_call, nbytes,
                                 product_rate, refuse_dtensor)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_block_ref, decode_attention_ref)

launches = 0
launches_block = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)        # the kernel's compiled head sizes
_MAX_GRID = 65535
# The CUDA-core kernel: 64-row tiles, at most 8 heads a block
TILE = 64                        # cache rows per tile
BLOCK_TARGET = 2 * 132           # blocks to aim for: two per H100 SM
# The tensor-core kernel (the constants of csrc/decode_attention.cu)
GRANULE = 16                     # rows of an MMA m-tile: the split unit
TC_SPLIT_ROWS = 64               # rows a split holds of a full cache
TC_MIN_WORK = 1024               # G * D from which G <= 8 takes it
TC_BLOCK_HEADS = 16              # query heads a block holds where G > 8
TC_WARPS = 4                     # warps a block
TC_MIN_BLOCKS = 4                # blocks an SM its registers always allow
TC_STAGES = 3                    # tiles in the ring
SMS = 132                        # H100 SXM
SMEM_PER_SM = 233472             # shared memory an SM holds (228 KiB)
SMEM_PER_BLOCK = 1024            # of it reserved for each resident block


def tensor_path(G: int, D: int) -> bool:
    """The rule between the two split kernels: tensor cores for groups
    of more than 8 heads (the CUDA-core kernel holds at most 8) and for
    8 over rows of 128 (G * D >= ``TC_MIN_WORK``: qwen3, the VLM); the
    CUDA-core kernel for G < 8 and for 8 over narrower rows.  TinyLlama's
    G = 8 at D = 64 stays there: the dry run holds its cost at the f32
    rate (``cost``), though the tensor-core kernel measured 7% faster
    there (PERF.md)."""
    return G > 8 or G * D >= TC_MIN_WORK


def num_splits(B: int, KV: int, S: int) -> int:
    """The CUDA-core kernel's blocks per (b, kv head) along the cache:
    enough for ``BLOCK_TARGET`` blocks over the B * KV pairs, at most
    one per ``TILE``-row tile of the cache, at least 1.  Shapes only:
    the kernel divides each row's valid range among the splits on the
    device, so the host never reads cur_len."""
    pairs = max(1, B * KV)
    return max(1, min(-(-S // TILE), -(-BLOCK_TARGET // pairs)))


def tc_heads(G: int) -> int:
    """Query heads a tensor-core block holds: G rounded up to whole
    n-tiles of 8, at most ``TC_BLOCK_HEADS`` (8 or 16: one n-tile
    warp each 8, the rest of the 4 warps along the rows)."""
    return min(TC_BLOCK_HEADS, 8 * -(-G // 8))


def _stride(D: int, c_bytes: int) -> int:
    """The tensor-core ring's row stride in 16-byte chunks (k and v):
    odd over a bfloat16 cache (ldmatrix reads 8 rows of 16 bytes at
    once), 2 mod 4 over float32 (8-byte fragment loads, 4 rows of 32
    bytes), so that every fragment load is free of bank conflicts."""
    nc = D * c_bytes // 16
    return nc | 1 if c_bytes == 2 else nc + (2 - nc) % 4


def tc_smem(D: int, q_bytes: int, c_bytes: int, hb: int) -> int:
    """Dynamic shared memory of a tensor-core block holding ``hb`` heads:
    q in its parts (over a bfloat16 cache three bfloat16 parts of a
    float32 q, over float32 TF32 hi and lo; one part of a bfloat16 q),
    then the larger of the ``TC_STAGES``-tile ring of k and v rows and
    the end's merge of its warps."""
    parts = (3 if c_bytes == 2 else 2) if q_bytes == 4 else 1
    rows = GRANULE * (TC_WARPS // (hb // 8))
    ring = 16 * TC_STAGES * rows * 2 * _stride(D, c_bytes)
    merge = 4 * TC_WARPS * 8 * (D + 8 + 2)
    return hb * D * min(c_bytes, 4) * parts + max(ring, merge)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One call's split pass: ``path`` "tensor" or "cuda-core"; the
    query heads a block holds (``heads``) and blocks of heads per KV
    head (``chunks``); cache rows of a block's tile (``rows``) and the
    split unit (``granule``); ``splits`` blocks along the cache; the
    grid (splits, KV * chunks, B); a tensor-core block's shared memory
    (``smem``) and blocks an SM holds (``resident``), 0 on the
    CUDA-core path."""
    path: str
    heads: int
    chunks: int
    rows: int
    granule: int
    splits: int
    grid: tuple
    smem: int = 0
    resident: int = 0


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, H: int, KV: int, D: int, q_dtype: torch.dtype,
         c_dtype: torch.dtype) -> Plan:
    """The split pass of a call at these shapes and types, from shapes
    alone.  On the tensor-core path the grid fills at most one wave of
    resident blocks, ``SMS * resident``, with at most one split per
    ``TC_SPLIT_ROWS`` rows of the cache (more splits cost the combine
    more than they save at B = 1); each split takes its share of the
    valid rows in ``GRANULE``-row units.  After changing a constant
    above, ``plan.cache_clear()``."""
    G = H // KV
    if not tensor_path(G, D):
        n = num_splits(B, KV, S)
        return Plan("cuda-core", G, 1, TILE, TILE, n, (n, KV, B))
    hb = tc_heads(G)
    chunks = -(-G // hb)
    smem = tc_smem(D, q_dtype.itemsize, c_dtype.itemsize, hb)
    resident = min(TC_MIN_BLOCKS, SMEM_PER_SM // (smem + SMEM_PER_BLOCK))
    pairs = max(1, B * KV * chunks)
    n = max(1, min(-(-S // TC_SPLIT_ROWS), SMS * resident // pairs))
    return Plan("tensor", hb, chunks, GRANULE * (TC_WARPS // (hb // 8)),
                GRANULE, n, (n, KV * chunks, B), smem, resident)


def split_shares(splits: int, granule: int, lo: int, hi: int) -> list:
    """Each split's rows of the valid range [lo, hi), as both split
    kernels divide it on the device: the ``granule``-row units that
    overlap it, in equal shares (the first ones one unit more), each
    share clipped to [lo, hi); () for a split with none."""
    u_lo = lo // granule
    n = -(-hi // granule) - u_lo if hi > lo else 0
    share, extra = divmod(n, splits)
    out = []
    for s in range(splits):
        u0 = u_lo + s * share + min(s, extra)
        u1 = u0 + share + (s < extra)
        out.append((max(lo, u0 * granule), min(hi, u1 * granule))
                   if u0 < u1 else ())
    return out


def tc_occupancy(D: int, q_dtype: torch.dtype, c_dtype: torch.dtype,
                 hb: int, device=None):
    """(shared memory a block, blocks an SM holds) of the tensor-core
    kernel at these types and ``hb`` heads a block, read from the card
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor): what ``plan``
    assumes."""
    fn = build.load("decode_attention").decode_attention_tc_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(D, _DTYPES[c_dtype], _DTYPES[q_dtype], hb,
                ctypes.addressof(smem), ctypes.addressof(blocks))
    if rc != 0:
        raise RuntimeError(f"decode_attention occupancy query failed: CUDA "
                           f"error {rc}")
    return smem.value, blocks.value


@functools.cache
def _entry():
    fn = build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry_block():
    fn = build.load("decode_attention").decode_attention_block_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _hb(p: Plan) -> int:
    """The C entry's choice of split kernel: heads a tensor-core block
    holds, 0 for the CUDA-core kernel."""
    return p.heads if p.path == "tensor" else 0


def _check(q, k_cache, v_cache, window):
    refuse_dtensor("decode_attention", q, k_cache, v_cache)
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q must be (B,1,H,D) and the "
                         f"caches (B,S,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, _, H, D = q.shape
    _, S, KV, Dk = k_cache.shape
    if k_cache.shape[0] != B or Dk != D or KV < 1 or H % KV:
        raise ValueError(f"decode_attention: shapes q {tuple(q.shape)} and "
                         f"cache {tuple(k_cache.shape)} do not fit "
                         f"(H = KV * G)")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {D} must be in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPES or k_cache.dtype not in _DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"decode_attention: q and the caches must be "
                        f"float32 or bfloat16, the two caches of one type; "
                        f"got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if k_cache.device != q.device or v_cache.device != q.device:
        raise ValueError("decode_attention: q and caches on different "
                         "devices")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("decode_attention: q and caches must be contiguous")
    if window < 0:
        raise ValueError(f"decode_attention: window must be >= 0, got "
                         f"{window}")
    G = H // KV
    chunks = -(-G // tc_heads(G)) if tensor_path(G, D) else 1
    if B > _MAX_GRID or KV * chunks > _MAX_GRID:
        raise ValueError(f"decode_attention: B={B} or KV={KV} (times "
                         f"{chunks} blocks of heads) over the grid limit "
                         f"{_MAX_GRID}")


def _cur_tensor(cur_len, B: int, device) -> torch.Tensor:
    if isinstance(cur_len, torch.Tensor):
        if cur_len.device != device:
            raise ValueError(f"decode_attention: cur_len on {cur_len.device}"
                             f", q on {device}")
        if cur_len.dim() == 0:
            cur_len = cur_len.expand(B)
        if cur_len.shape != (B,):
            raise ValueError(f"decode_attention: cur_len must be ({B},), "
                             f"got {tuple(cur_len.shape)}")
        return cur_len.to(torch.int32).contiguous()
    return torch.full((B,), int(cur_len), dtype=torch.int32, device=device)


def _rate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """(ops_per_s, per_op) of a call's products: bfloat16 q over a
    bfloat16 cache at BF16_OPS_PER_S (``product_rate``); with a float32
    operand, on the CUDA-core path F32_OPS_PER_S, on the tensor-core
    path the products the kernel runs: over a bfloat16 cache three
    bfloat16 products per product (q and p in three bfloat16 parts),
    over a float32 cache 3xTF32 (``product_rate``'s default, as
    flash_attention)."""
    if not tensor_path(q.shape[2] // k.shape[2], q.shape[3]):
        return product_rate(q, k, v, f32=(F32_OPS_PER_S, 1))
    if k.dtype == torch.bfloat16:
        return product_rate(q, k, v, f32=(BF16_OPS_PER_S, 3))
    return product_rate(q, k, v)


def cost(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         cur_len=None, *, window: int = 0) -> KernelCost:
    """One call's work: q read, o written, the int32 (B,) cur_len read,
    and of k and v the rows the call reads, sum over rows of min(cur_len,
    S) (min(cur_len, window) with a window), against 4 D operations per
    row read and query head at the rate of the kernel the call takes
    (``_rate``).  Where the host does not know cur_len (None, or a
    tensor on the meta device) every row is read whole."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if cur_len is None or (isinstance(cur_len, torch.Tensor)
                           and cur_len.is_meta):
        valid = B * (min(S, window) if window else S)
    else:
        cur = torch.as_tensor(cur_len).expand(B).clamp(max=S)
        if window:
            cur = cur.clamp(max=window)
        valid = int(cur.sum())
    return KernelCost(4 * D * H * valid,
                      nbytes(q, q) + 4 * B
                      + 2 * valid * KV * D * k_cache.element_size(),
                      *_rate(q, k_cache, v_cache))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cur_len, *,
                     window: int = 0) -> torch.Tensor:
    """One query token per row against the cache: q (B,1,H,D), caches
    (B,S,KV,D), ``cur_len`` (B,) (or one int) valid entries per row,
    including the token just written.  Positions >= cur_len, and with
    ``window`` those < cur_len - window, are masked.  f32 scores, softmax
    and PV product; output in q's type."""
    global launches
    _check(q, k_cache, v_cache, window)
    B, _, H, D = q.shape
    cur = _cur_tensor(cur_len, B, q.device)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, cur, window=window)
    if torch.is_grad_enabled() and (q.requires_grad or k_cache.requires_grad
                                    or v_cache.requires_grad):
        raise NotImplementedError(
            "decode_attention: the kernel has no backward (nor has the TPU "
            "kernel it replaces); call it under torch.no_grad() or on "
            "inputs that need no gradient")
    if q.device.type == "meta":
        return meta_call("decode_attention",
                         lambda: cost(q, k_cache, v_cache, cur,
                                      window=window),
                         lambda: torch.empty_like(q))
    S, KV = k_cache.shape[1], k_cache.shape[2]
    qp, kp, vp = q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("decode_attention: q and the caches must start "
                         "on a 16-byte boundary (the kernel loads 16-byte "
                         "chunks)")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    p = plan(B, S, H, KV, D, q.dtype, k_cache.dtype)
    part = torch.empty((B, H, p.splits, D + 2), dtype=torch.float32,
                       device=q.device)
    rc = launch(_entry(), q.get_device(), qp, kp, vp, cur.data_ptr(),
                part.data_ptr(), o.data_ptr(), B, S, H, KV, D, int(window),
                1.0 / math.sqrt(D), p.splits, _hb(p), _DTYPES[q.dtype],
                _DTYPES[k_cache.dtype])
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc} at q {tuple(q.shape)}, cache "
                           f"{tuple(k_cache.shape)}")
    launches += 1
    return o


def _block_rows(cur_len, B: int, S: int, window: int, offset: int,
                lo) -> int:
    """Rows of a block at ``offset`` of S rows valid in the whole cache:
    the sum over rows of |[max(cur - window, lo), cur) & [offset, offset
    + S)|."""
    cur = torch.as_tensor(cur_len).expand(B).to(torch.int64)
    first = cur - window if window else torch.zeros_like(cur)
    if lo is not None:
        first = torch.maximum(first, torch.as_tensor(lo).to(torch.int64))
    hi = torch.clamp(cur - offset, max=S)
    return int(torch.clamp(hi - torch.clamp(first - offset, min=0),
                           min=0).sum())


def cost_block(q: torch.Tensor, k_block: torch.Tensor,
               v_block: torch.Tensor, cur_len=None, *, window: int = 0,
               offset: int = 0, lo=None) -> KernelCost:
    """One ``decode_attention_block`` call's work: q and the int32
    cur_len (and lo) read, o and lse written in float32, and of the
    block's k and v only the rows valid in the whole cache, each read
    once, against 4 D operations per such row and query head, at
    ``cost``'s rates.  Where the host does not know cur_len (None, or a
    tensor on the meta device) every row of the block within the window
    is read."""
    B, _, H, D = q.shape
    S, KV = k_block.shape[1], k_block.shape[2]
    if cur_len is None or (isinstance(cur_len, torch.Tensor)
                           and cur_len.is_meta) or (
            isinstance(lo, torch.Tensor) and lo.is_meta):
        valid = B * (min(S, window) if window else S)
    else:
        valid = _block_rows(cur_len, B, S, window, offset, lo)
    return KernelCost(4 * D * H * valid,
                      nbytes(q) + 4 * B * (1 if lo is None else 2)
                      + 4 * B * H * (D + 1)
                      + 2 * valid * KV * D * k_block.element_size(),
                      *_rate(q, k_block, v_block))


def decode_attention_block(q: torch.Tensor, k_block: torch.Tensor,
                           v_block: torch.Tensor, cur_len, *,
                           window: int = 0, offset: int = 0, lo=None):
    """Decode attention over one block of a cache split along its
    sequence axis: q (B,1,H,D), the block's rows k_block, v_block
    (B,S_b,KV,D) at global positions [offset, offset + S_b), cur_len
    (B,) (or one int) and ``window`` global, as ``decode_attention``
    takes them, and ``lo`` (B,) (or None) each row's first valid
    position besides.  Returns (o, lse): o (B,1,H,D) float32, the
    block's output (not cast to q's type), lse (B,H) float32, the
    log-sum-exp of its scaled scores; a block with no valid row gives
    o = 0, lse = -inf (no NaN)."""
    global launches_block
    _check(q, k_block, v_block, window)
    if offset < 0:
        raise ValueError(f"decode_attention_block: offset must be >= 0, "
                         f"got {offset}")
    B, _, H, D = q.shape
    cur = _cur_tensor(cur_len, B, q.device)
    lo_t = None if lo is None else _cur_tensor(lo, B, q.device)
    if q.device.type == "cpu":
        return decode_attention_block_ref(q, k_block, v_block, cur,
                                          window=window, offset=offset,
                                          lo=lo_t)
    if torch.is_grad_enabled() and (q.requires_grad
                                    or k_block.requires_grad
                                    or v_block.requires_grad):
        raise NotImplementedError(
            "decode_attention_block: the kernel has no backward; call it "
            "under torch.no_grad() or on inputs that need no gradient")

    def outputs():
        return (torch.empty(q.shape, dtype=torch.float32, device=q.device),
                torch.empty((B, H), dtype=torch.float32, device=q.device))
    if q.device.type == "meta":
        return meta_call("decode_attention_block",
                         lambda: cost_block(q, k_block, v_block, cur,
                                            window=window, offset=offset,
                                            lo=lo_t), outputs)
    S, KV = k_block.shape[1], k_block.shape[2]
    qp, kp, vp = q.data_ptr(), k_block.data_ptr(), v_block.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("decode_attention_block: q and the block must "
                         "start on a 16-byte boundary")
    o, lse = outputs()
    if q.numel() == 0:
        return o, lse
    p = plan(B, S, H, KV, D, q.dtype, k_block.dtype)
    part = torch.empty((B, H, p.splits, D + 2), dtype=torch.float32,
                       device=q.device)
    rc = launch(_entry_block(), q.get_device(), qp, kp, vp, cur.data_ptr(),
                None if lo_t is None else lo_t.data_ptr(), part.data_ptr(),
                o.data_ptr(), lse.data_ptr(), B, S, H, KV, D, int(window),
                int(offset), 1.0 / math.sqrt(D), p.splits, _hb(p),
                _DTYPES[q.dtype], _DTYPES[k_block.dtype])
    if rc != 0:
        raise RuntimeError(f"decode_attention_block kernel launch failed: "
                           f"CUDA error {rc} at q {tuple(q.shape)}, block "
                           f"{tuple(k_block.shape)}, offset {offset}")
    launches_block += 1
    return o, lse
