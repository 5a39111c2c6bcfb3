"""Plain PyTorch RMSNorm, mirroring ``repro/kernels/rmsnorm/ref.py``:
``x * rsqrt(mean(x^2) + eps) * scale`` in float32, cast to x's type."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
