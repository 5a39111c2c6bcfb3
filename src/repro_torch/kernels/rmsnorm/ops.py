"""Wrapper for fused RMSNorm over the last axis.

A CPU tensor goes to the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the kernel of ``csrc/rmsnorm.cu`` or raises.
``launches`` counts kernel launches, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, launch
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2 ** 31 - 1


@functools.cache
def _entry():
    fn = build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale):
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: x and scale must be float32 or bfloat16, "
                        f"got {x.dtype} and {scale.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm: scale must have shape (d,) = "
                         f"{tuple(x.shape[-1:])}, got {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"rmsnorm: scale on {scale.device}, x on "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` with float32 statistics;
    output in x's type.  x: (..., d), scale: (d,)."""
    global launches
    _check(x, scale)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    if rows > _MAX_ROWS:
        raise ValueError(f"rmsnorm: {rows} rows exceed the grid limit")
    rc = launch(_entry(), x.device, x.data_ptr(), scale.data_ptr(),
                y.data_ptr(), rows, d, float(eps), _DTYPES[x.dtype],
                _DTYPES[scale.dtype])
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc} "
                           f"at shape {tuple(x.shape)}")
    launches += 1
    return y
