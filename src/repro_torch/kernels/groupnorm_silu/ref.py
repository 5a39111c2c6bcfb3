"""Plain PyTorch fused GroupNorm + SiLU (NHWC), mirroring
``repro/kernels/groupnorm_silu/ref.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def num_groups_for(channels: int, num_groups: int) -> int:
    """G: the largest divisor of ``channels`` that is <= ``num_groups``."""
    G = min(num_groups, channels)
    while channels % G:
        G -= 1
    return G


def group_norm_ref(x: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, num_groups: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over contiguous channel groups: f32 statistics
    (population variance), f32 scale and bias, result in f32."""
    B, H, W, C = x.shape
    G = num_groups_for(C, num_groups)
    xg = x.reshape(B, H, W, G, C // G).float()
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, correction=0)
    out = (xg - mu) * torch.rsqrt(var + eps)
    return out.reshape(B, H, W, C) * scale + bias


def groupnorm_silu_ref(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, num_groups: int,
                       eps: float = 1e-6) -> torch.Tensor:
    return F.silu(group_norm_ref(x, scale, bias, num_groups, eps)).to(
        x.dtype)
