"""KV-cache storage helpers, in PyTorch.

The port of ``repro.models.kv_cache``'s ``alloc``, ``write`` and
``read``: bfloat16 (default), float32, and the int8 dict cache
(symmetric per-(position, head) quantization: ``{"q": int8 (B,S,KV,D),
"s": float32 (B,S,KV)}``).

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


def write_index(pos: torch.Tensor, n: int, S: int):
    """Where n <= S consecutive positions from pos (B,) go in a cache of
    length S: (rows, slots, keep), each (B, n).  Computed once, it
    serves every layer's k and v write of a decode step."""
    if n > S:
        raise ValueError(f"write_index: {n} positions exceed the cache "
                         f"length {S}")
    idx = pos.to(torch.int64)[:, None] + torch.arange(n, device=pos.device)
    keep = (idx >= -S) & (idx < S)
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    return rows.expand_as(idx), torch.remainder(idx, S), keep


def _put_(buf: torch.Tensor, new: torch.Tensor, index) -> None:
    rows, slots, keep = index
    old = buf[rows, slots]
    mask = keep.reshape(keep.shape + (1,) * (old.dim() - 2))
    buf[rows, slots] = torch.where(mask, new.to(buf.dtype), old)


def write_(cache, new: torch.Tensor, pos: torch.Tensor, index=None):
    """In place: write new (B, S_new, KV, D) at positions pos (B,) ..
    pos+S_new of ``cache`` (a tensor or an int8 dict); returns it.
    ``index``: ``write_index(pos, S_new, S)``, when the caller has it."""
    S = (cache["q"] if isinstance(cache, dict) else cache).shape[1]
    if isinstance(cache, dict):
        q, scale = quantize(new)
        parts = [(cache["q"], q), (cache["s"], scale)]
    else:
        parts = [(cache, new)]
    S_new = new.shape[1]
    for lo in range(0, S_new, S):
        n = min(S, S_new - lo)
        at = index if index is not None and n == S_new \
            else write_index(pos + lo, n, S)
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
