"""Wrapper for fused GroupNorm + SiLU (NHWC).

A CPU tensor goes to the plain version (``ref.groupnorm_silu_ref``); a
CUDA tensor launches the kernel of ``csrc/groupnorm_silu.cu`` or raises.
``launches`` counts kernel launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.groupnorm_silu.ref import (groupnorm_silu_ref,
                                                    num_groups_for)

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = build.load("groupnorm_silu").groupnorm_silu_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale, bias, num_groups):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"groupnorm_silu: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"groupnorm_silu: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"groupnorm_silu: x must be NHWC (B,H,W,C), got "
                         f"shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("groupnorm_silu: x must be NHWC-contiguous")
    C = x.shape[-1]
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (C,) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError(
                f"groupnorm_silu: {name} must be a contiguous float32 "
                f"({C},) tensor on {x.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}")
    if num_groups < 1:
        raise ValueError(f"groupnorm_silu: num_groups must be >= 1, got "
                         f"{num_groups}")
    return num_groups_for(C, num_groups)      # divides C by construction


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """SiLU(GroupNorm(x) * scale + bias) with G = the largest divisor of
    C that is <= ``num_groups``; output in x's dtype."""
    global launches
    G = _check(x, scale, bias, num_groups)
    if x.device.type == "cpu":
        return groupnorm_silu_ref(x, scale, bias, num_groups, eps)
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rc = launch(_entry(), x.device, x.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), B, H * W, C, G, float(eps),
                _DTYPES[x.dtype])
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: CUDA "
                           f"error {rc} at shape {tuple(x.shape)}")
    launches += 1
    return y
