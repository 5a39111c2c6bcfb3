"""Plain PyTorch single-token decode attention over a KV cache,
mirroring ``repro/kernels/decode_attention/ref.py``: float32 scores,
softmax and PV product (p stays float32, as in the Pallas kernel, not
cast to the cache's type as the JAX model's own jnp path does).

One difference from the kernels, kept from the reference: a row with
``cur_len = 0`` has every position masked.  This version then gives a
uniform softmax over the masked scores, the mean of v; the Pallas kernel
and the CUDA kernel process no cache block for that row and give 0.
The serving path never passes 0 (``cur_len = pos + 1 >= 1``).
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cur_len, *,
                         window: int = 0) -> torch.Tensor:
    """q: (B, 1, H, D); caches: (B, S, KV, D); cur_len: (B,) valid
    entries (or one int for all rows).  Masks positions >= cur_len and,
    with ``window``, < cur_len - window.  Output in q's type."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    cur = torch.as_tensor(cur_len, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(B)
    qr = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float()) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    valid = pos[None] < cur[:, None]
    if window:
        valid &= pos[None] >= (cur[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


def decode_attention_block_ref(q: torch.Tensor, k_block: torch.Tensor,
                               v_block: torch.Tensor, cur_len, *,
                               window: int = 0, offset: int = 0, lo=None):
    """One block of a cache split along its sequence axis: the rows of
    k_block, v_block (B, S_b, KV, D) sit at global positions [offset,
    offset + S_b), and a row is valid where ``decode_attention_ref``
    would keep it in the whole cache (position < cur_len and, with
    ``window``, >= cur_len - window), and where given >= ``lo`` (B,).
    Returns (o, lse), both float32: o (B, 1, H, D) the block's attention
    output, lse (B, H) the log-sum-exp of its scaled scores; a block with
    no valid row gives o = 0 and lse = -inf.  ``lse_combine`` merges
    blocks."""
    B, _, H, D = q.shape
    S, KV = k_block.shape[1], k_block.shape[2]
    cur = torch.as_tensor(cur_len, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(B)
    qr = q.reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qr, k_block.float()) / math.sqrt(D)
    pos = offset + torch.arange(S, device=q.device)
    valid = pos[None] < cur[:, None]
    if window:
        valid &= pos[None] >= (cur[:, None] - window)
    if lo is not None:
        valid &= pos[None] >= torch.as_tensor(lo, device=q.device)[:, None]
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_block.float()) \
        / l.clamp(min=1e-30)
    lse = (m + torch.log(l)).reshape(B, H)
    return o.reshape(B, 1, H, D), lse


def lse_combine(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """Blocks' (o, lse) stacked on a leading axis, o (n, B, 1, H, D) and
    lse (n, B, H), merged into the attention output over their union
    (float32): each block weighted by exp(lse - max lse).  A row no
    block holds a valid position of gives 0."""
    m = lse.amax(dim=0)
    w = torch.exp(lse - torch.where(torch.isfinite(m), m, 0.0))
    num = (o * w[:, :, None, :, None]).sum(dim=0)
    return num / w.sum(dim=0).clamp(min=1e-30)[:, None, :, None]
