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
