"""Plain PyTorch attention (GQA, causal with sequence ends aligned,
optional sliding window), mirroring
``repro/kernels/flash_attention/ref.py``; ``q_offset`` places the
queries elsewhere (continuation attention, the reference model's
``chunked_attention(q_offset=...)``).

Materializes the full Sq x Skv score tensor in float32: right, and
O(S^2) in memory, which is fine at the serving path's prompt lengths.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset=None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D); H = KV * G.  Query i
    sits at key position i + q_offset (default Skv - Sq: ends aligned).
    A row whose keys are all masked gets the mean of v (the kernel
    gives 0).  Output in q's type."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    qr = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) / math.sqrt(D)
    off = Skv - Sq if q_offset is None else q_offset
    qpos = torch.arange(Sq, device=q.device)[:, None] + off
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= (qpos - kpos) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)
