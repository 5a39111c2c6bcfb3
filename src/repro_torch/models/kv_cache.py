"""KV-cache storage helpers, in PyTorch.

The port of ``repro.models.kv_cache``'s ``alloc``, ``write`` and
``read``: bfloat16 (default), float32, and the int8 dict cache
(symmetric per-(position, head) quantization: ``{"q": int8 (B,S,KV,D),
"s": float32 (B,S,KV)}``).

The layer-stacked helpers of the reference's in-place decode
(``decode_inplace_cache``) are here too: ``layer_view``, ``read_layer``,
``write_layer`` (with ``uniform``) and ``slice_window``.  Where the
reference updates a buffer carried through its layer scan, the port
writes the layer's view of the caller's buffer in place.

On DTensor buffers (a cache placed over a device mesh) ``write_`` and
``write_layer`` write each rank's block in place (``local_blocks``);
``read`` dequantizes as DTensor ops.  Where the buffer's sequence axis
is split too (``shard_kv_seq``), the reference's semantics are applied
to the global position first (``write_index``'s keep and remainder,
``uniform``'s clamped start), and each rank then writes the entries
that land in its block of rows (``write_index``); the int8 cache's
scales split with its values.

``write`` keeps the reference's ``mode="drop"`` semantics: an index in
[-S, 0) counts from the end (jax normalizes it so), and an index
outside [-S, S) is dropped.  ``write_`` does the same in place, without
a host sync: the S_new consecutive positions of one row are distinct
modulo S whenever S_new <= S, so every entry writes to its own slot,
and a dropped entry writes back the value it read there (longer writes
go in chunks of S).  ``write`` is ``write_`` on a copy, pure as the
reference's is.
"""

from __future__ import annotations

import torch

from repro_torch.models.params import is_dtensor, seq_blocks

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def alloc(batch: int, max_len: int, kv_heads: int, head_dim: int,
          dtype_str: str = "bfloat16", device="cuda"):
    """One unstacked (B, S, KV, D) buffer of zeros (a dict for int8);
    ``device="meta"`` gives shapes without storage."""
    shape = (batch, max_len, kv_heads, head_dim)
    if dtype_str == "int8":
        return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                 device=device)}
    return torch.zeros(shape, dtype=_DTYPES[dtype_str], device=device)


def quantize(new: torch.Tensor):
    """int8 values and per-(position, head) f32 scales of ``new``."""
    nf = new.float()
    scale = nf.abs().amax(dim=-1) / 127.0
    q = torch.round(nf / torch.clamp(scale, min=1e-8)[..., None])
    return q.to(torch.int8), scale


def write_index(pos: torch.Tensor, n: int, S: int, block=None):
    """Where n <= S consecutive positions from pos (B,) go in a cache of
    length S, on the rank that holds its rows [offset, offset + R),
    ``block`` = (offset, R) (None: the whole cache, (0, S)): (rows,
    slots, keep, src), each (B, n).  Each entry's global slot is taken
    with the reference's drop semantics (``remainder``; kept where its
    position lies in [-S, S)), then clamped into the block; the entry
    that lands on that slot in the whole cache (at most one, as n <= S)
    is ``src``, and ``keep`` says whether there is one and the
    reference keeps it.  Entries clamped onto one slot carry the same
    value (that entry's, or the slot's own), so the scatter's order
    cannot matter, and the rank writes nothing outside its rows.
    Computed once, it serves every layer's k and v write of a decode
    step."""
    if n > S:
        raise ValueError(f"write_index: {n} positions exceed the cache "
                         f"length {S}")
    offset, R = (0, S) if block is None else block
    p = pos.to(torch.int64)[:, None]
    slots = torch.clamp(torch.remainder(
        p + torch.arange(n, device=pos.device), S) - offset, 0, R - 1)
    src = torch.remainder(slots + offset - p, S)
    keep = (src < n) & (p + src >= -S) & (p + src < S)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return rows.expand_as(slots), slots, keep, torch.clamp(src, max=n - 1)


def _put_(buf: torch.Tensor, new: torch.Tensor, index) -> None:
    rows, slots, keep, src = index
    old = buf[rows, slots]
    mask = keep.reshape(keep.shape + (1,) * (old.dim() - 2))
    buf[rows, slots] = torch.where(mask, new[rows, src].to(buf.dtype), old)


def local_blocks(buf, new, pos, lead: int = 0):
    """Each rank's blocks for an in-place write of DTensor ``new``
    (*lead, B, S_new, KV, D) into the DTensor buffer ``buf`` (*lead, B,
    S, KV, D; an int8 dict of them) at ``pos`` (B,): ``new`` and ``pos``
    are first placed as the buffer (batch and KV heads alike; ``new``
    whole along the sequence).  Returns (buf, new, pos, block) with local
    tensors, ``buf``'s sharing its storage, and ``block`` = (offset, S)
    where the buffer's sequence axis is split (``write_index``), else
    None."""
    from torch.distributed.tensor import Replicate, Shard
    first = buf["q"] if isinstance(buf, dict) else buf
    mesh, pl = first.device_mesh, tuple(first.placements)
    seq = [i for i, p in enumerate(pl)
           if isinstance(p, Shard) and p.dim == lead + 1]
    new_pl = tuple(Replicate() if i in seq else p for i, p in enumerate(pl))
    pos_pl = tuple(Shard(0) if isinstance(p, Shard) and p.dim == lead
                   else Replicate() for p in pl)
    local = {k: t.to_local() for k, t in buf.items()} \
        if isinstance(buf, dict) else buf.to_local()
    block = None
    if seq:
        S = first.shape[lead + 1]
        block = (seq_blocks(mesh, seq, S).offset, S)
    return (local, new.redistribute(mesh, new_pl).to_local(),
            pos.redistribute(mesh, pos_pl).to_local(), block)


def write_(cache, new: torch.Tensor, pos: torch.Tensor, index=None,
           block=None):
    """In place: write new (B, S_new, KV, D) at positions pos (B,) ..
    pos+S_new of ``cache`` (a tensor or an int8 dict); returns it.
    ``index``: ``write_index(pos, S_new, S)``, when the caller has it
    (not on DTensors: each rank writes its block).  ``block``: (offset,
    S) when ``cache`` is the rows [offset, ...) of a cache of S rows
    split along its sequence axis (``local_blocks``)."""
    if is_dtensor(cache["q"] if isinstance(cache, dict) else cache):
        local, new, pos, block = local_blocks(cache, new, pos)
        write_(local, new, pos, block=block)
        return cache
    R = (cache["q"] if isinstance(cache, dict) else cache).shape[1]
    offset, S = (0, R) if block is None else block
    if isinstance(cache, dict):
        q, scale = quantize(new)
        parts = [(cache["q"], q), (cache["s"], scale)]
    else:
        parts = [(cache, new)]
    S_new = new.shape[1]
    for lo in range(0, S_new, S):
        n = min(S, S_new - lo)
        at = index if index is not None and n == S_new \
            else write_index(pos + lo, n, S, (offset, R))
        for buf, val in parts:
            _put_(buf, val[:, lo:lo + n], at)
    return cache


def clone(cache):
    if isinstance(cache, dict):
        return {k: v.clone() for k, v in cache.items()}
    return cache.clone()


def write(cache, new: torch.Tensor, pos: torch.Tensor):
    """Write new (B, S_new, KV, D) at positions pos (B,) .. pos+S_new;
    returns a new cache and leaves ``cache`` as it was."""
    return write_(clone(cache), new, pos)


def read(cache) -> torch.Tensor:
    """A dense (B, S, KV, D) view (dequantized to float32 if int8)."""
    if isinstance(cache, dict):
        return cache["q"].float() * cache["s"][..., None]
    return cache


# ---------------------------------------------------------------------------
# Layer-stacked in-place variants (decode_inplace_cache): the cache keeps
# its (lead..., B, S, KV, D) stacked layout; writes go to one layer's view
# in place, reads take a view of one layer.
# ---------------------------------------------------------------------------

def layer_view(cache_all, lead_idx: tuple):
    """One layer's (B, S, KV, D) buffer of a stacked cache (a dict of
    views for int8, not dequantized): a view, not a copy.  ``lead_idx``
    is a tuple of layer indices (``()``: the buffer itself)."""
    if isinstance(cache_all, dict):
        return {k: v[lead_idx] for k, v in cache_all.items()}
    return cache_all[lead_idx]


def read_layer(cache_all, lead_idx: tuple) -> torch.Tensor:
    """Dense (dequantized if int8) (B, S, KV, D) view of one layer."""
    return read(layer_view(cache_all, lead_idx))


def write_layer(cache_all, lead_idx: tuple, new: torch.Tensor,
                pos: torch.Tensor, uniform: bool = False, index=None):
    """In place: write new (B, S_new, KV, D) into layer ``lead_idx`` of
    ``cache_all`` (lead..., B, S, KV, D) at positions pos (B,) (int8:
    quantized per (position, head) first, as ``write``); returns
    ``cache_all``.

    ``uniform=True`` is the reference's contiguous update: every row is
    written at ``pos[0]``, whatever its own position, the start taken as
    ``lax.dynamic_update_slice`` takes it (``_dynamic_start``: counted
    from the end when negative, then clamped to [0, S - S_new]; a row
    at another position is written at the wrong place: that is
    the reference's contract for serving steps that share one
    position).  Otherwise each row goes to its own position with
    ``write``'s drop semantics; ``index``: ``write_index(pos, S_new,
    S)``, when the caller has it."""
    view = layer_view(cache_all, lead_idx)
    block = None
    if is_dtensor(view["q"] if isinstance(view, dict) else view):
        view, new, pos, block = local_blocks(view, new, pos)
        index = None
    if isinstance(view, dict):
        q, scale = quantize(new)
        _write_layer_arr(view["q"], q, pos, uniform, index, block)
        _write_layer_arr(view["s"], scale, pos, uniform, index, block)
    else:
        _write_layer_arr(view, new, pos, uniform, index, block)
    return cache_all


def _write_layer_arr(buf: torch.Tensor, new: torch.Tensor,
                     pos: torch.Tensor, uniform: bool, index,
                     block=None) -> None:
    if not uniform:
        write_(buf, new, pos, index, block)
        return
    R, n = buf.shape[1], new.shape[1]
    offset, S = (0, R) if block is None else block
    if n > S:
        raise ValueError(f"write_layer: {n} positions exceed the cache "
                         f"length {S}")
    # the start stays on the device: no host read of pos
    idx = _dynamic_start(pos[:1], S, n) + torch.arange(n, device=buf.device)
    # the slots of this rank's rows (all of them on a whole cache), each
    # written with its entry of the update or with its own value (as
    # write_index)
    slots = torch.clamp(idx - offset, 0, R - 1)
    src = slots + offset - idx[0]
    keep = ((src >= 0) & (src < n)).reshape((n,) + (1,) * (buf.dim() - 2))
    val = torch.where(keep, new.index_select(1, src.clamp(0, n - 1)).to(
        buf.dtype), buf.index_select(1, slots))
    buf.index_copy_(1, slots, val)


def _dynamic_start(start, S: int, n: int) -> torch.Tensor:
    """The first index of an n-long slice at ``start`` of an axis of S,
    as jax's dynamic slices take it: a negative start counts from the
    end, then the start is clamped to [0, S - n]."""
    start = start.to(torch.int64)
    return torch.clamp(torch.where(start < 0, start + S, start), 0, S - n)


def slice_window(layer_cache, start, window: int):
    """Rows [start, start + window) along the sequence axis of a (B, S,
    KV, D) layer view (decode_slice_reads), the start taken as
    ``lax.dynamic_slice_in_dim`` takes it (``_dynamic_start``); ``start``
    may be a 0-d device tensor (no host read).  A contiguous copy of the
    window (the decode kernel reads contiguous caches), not a view."""
    def sl(x):
        first = _dynamic_start(torch.as_tensor(start, device=x.device),
                               x.shape[1], window)
        return x.index_select(1, first + torch.arange(window,
                                                      device=x.device))
    if isinstance(layer_cache, dict):
        return {k: sl(v) for k, v in layer_cache.items()}
    return sl(layer_cache)
