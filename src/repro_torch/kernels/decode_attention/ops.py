"""Wrapper for flash-decode attention.

A CPU tensor goes to the plain version (``ref.decode_attention_ref``);
a CUDA tensor launches the kernels of ``csrc/decode_attention.cu`` (a
split-K pass over the valid cache, grid ``(splits, KV * head_chunks(G),
B)`` with ``splits = num_splits(B, KV * head_chunks(G), S)``, then a
combine pass) or raises.  Any group size G = H / KV runs, as in the
Pallas kernel: a block holds up to ``BLOCK_HEADS`` query heads of one
KV head.  q and the cache may differ in
type (float32 q over a bfloat16 cache is the serving path's default).
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
import functools
import math

import torch

from repro_torch.kernels import (F32_OPS_PER_S, KernelCost, build, launch,
                                 meta_call, nbytes, product_rate,
                                 refuse_dtensor)
from repro_torch.kernels.decode_attention.ref import (
    decode_attention_block_ref, decode_attention_ref)

launches = 0
launches_block = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)        # the kernel's compiled head sizes
BLOCK_HEADS = 64                 # query heads one block of the kernel holds
_MAX_GRID = 65535
TILE = 64                        # cache rows per tile of the kernel
BLOCK_TARGET = 2 * 132           # blocks to aim for: two per H100 SM


def head_chunks(G: int) -> int:
    """Blocks along the grid's y axis per KV head: one per
    ``BLOCK_HEADS`` query heads of its group."""
    return -(-G // BLOCK_HEADS)


def num_splits(B: int, KV: int, S: int) -> int:
    """Blocks per (b, kv head) along the cache: enough for
    ``BLOCK_TARGET`` blocks over the B * KV pairs, at most one per
    ``TILE``-row tile of the cache, at least 1.  Shapes only: the kernel
    divides each row's valid range among the splits on the device, so
    the host never reads cur_len."""
    pairs = max(1, B * KV)
    return max(1, min(-(-S // TILE), -(-BLOCK_TARGET // pairs)))


@functools.cache
def _entry():
    fn = build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _entry_block():
    fn = build.load("decode_attention").decode_attention_block_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    if B > _MAX_GRID or KV * head_chunks(H // KV) > _MAX_GRID:
        raise ValueError(f"decode_attention: B={B} or KV={KV} (times "
                         f"{head_chunks(H // KV)} blocks of heads) over "
                         f"the grid limit {_MAX_GRID}")


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


def cost(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         cur_len=None, *, window: int = 0) -> KernelCost:
    """One call's work: q read, o written, the int32 (B,) cur_len read,
    and of k and v the rows the call reads, sum over rows of min(cur_len,
    S) (min(cur_len, window) with a window), against 4 D operations per
    row read and query head: float32 at F32_OPS_PER_S where q or the
    cache is float32 (the kernel's CUDA cores), bfloat16 q over a
    bfloat16 cache at BF16_OPS_PER_S (``product_rate``).  Where the host
    does not know cur_len (None, or a tensor on the meta device) every
    row is read whole."""
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
                      *product_rate(q, k_cache, v_cache,
                                    f32=(F32_OPS_PER_S, 1)))


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
    splits = num_splits(B, KV * head_chunks(H // KV), S)
    part = torch.empty((B, H, splits, D + 2), dtype=torch.float32,
                       device=q.device)
    rc = launch(_entry(), q.get_device(), qp, kp, vp, cur.data_ptr(),
                part.data_ptr(), o.data_ptr(), B, S, H, KV, D, int(window),
                1.0 / math.sqrt(D), splits, _DTYPES[q.dtype],
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
                      *product_rate(q, k_block, v_block,
                                    f32=(F32_OPS_PER_S, 1)))


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
    splits = num_splits(B, KV * head_chunks(H // KV), S)
    part = torch.empty((B, H, splits, D + 2), dtype=torch.float32,
                       device=q.device)
    rc = launch(_entry_block(), q.get_device(), qp, kp, vp, cur.data_ptr(),
                None if lo_t is None else lo_t.data_ptr(), part.data_ptr(),
                o.data_ptr(), lse.data_ptr(), B, S, H, KV, D, int(window),
                int(offset), 1.0 / math.sqrt(D), splits, _DTYPES[q.dtype],
                _DTYPES[k_block.dtype])
    if rc != 0:
        raise RuntimeError(f"decode_attention_block kernel launch failed: "
                           f"CUDA error {rc} at q {tuple(q.shape)}, block "
                           f"{tuple(k_block.shape)}, offset {offset}")
    launches_block += 1
    return o, lse
