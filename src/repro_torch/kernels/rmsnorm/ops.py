"""Wrapper for fused RMSNorm over the last axis.

A CPU tensor goes to the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the kernel of ``csrc/rmsnorm.cu`` or raises.  Under grad
mode, when x or scale needs a gradient, the launch goes through
``kernels.KernelFunction``: the kernel's forward, and as backward the
plain version's autograd recomputed from the saved inputs
(``rmsnorm_backward``), since the TPU kernel has no backward to port.
``launches`` counts kernel launches, so a run can show that its path
went through the kernel.  A meta tensor gets the output's shape and
type, no arithmetic (``kernels.meta_call``); ``cost`` is a call's work.
``plan`` chooses the kernel's block for a row width: a plain function of
the width, so that it can be checked without a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import (KernelCost, build, launch, meta_call,
                                 nbytes, plain_backward, refuse_dtensor,
                                 with_grad)
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

launches = 0
OPS_PER_ELEMENT = 4         # x*x+acc, /d+eps (per row), *rsqrt, *w

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2 ** 31 - 1

NV = (1, 2, 3, 4, 5)        # vectors a thread holds (the kernel's templates;
                            # 16-byte vectors from 2 up)
NV_AIM = 4                  # vectors a thread aims for among the plans that
                            # hold a row with the fewest idle lanes (4 beat
                            # 2, 3 and 5 at prefill at every f32 path
                            # width, PERF.md)
MIN_THREADS = 64
MAX_THREADS = 1024          # the kernel's __launch_bounds__ for scalar
                            # loads or nv <= 2
WIDE_THREADS = 512          # ... and for more 16-byte vectors (x and
                            # scale held: <= 128 registers a thread)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's block for rows of one width: one block of
    ``threads`` threads per row, each holding ``nv`` vectors of ``vec``
    elements (and the scale beside them); ``chunks`` > 1: the row is
    wider than a block holds and x is read again."""
    threads: int
    nv: int
    vec: int
    chunks: int


def max_threads(nv: int, vec: int) -> int:
    return MAX_THREADS if vec == 1 or nv <= 2 else WIDE_THREADS


@functools.lru_cache(maxsize=256)     # called on every launch
def plan(d: int, elem_bytes: int, aligned: bool = True) -> Plan:
    """The block for rows of ``d`` elements of ``elem_bytes``.
    ``aligned``: x's, y's and scale's addresses are 16-byte aligned.

    ``vec`` is 16 bytes of x where d and the addresses allow it, else 1.
    Of the (threads, nv) that hold a whole row, the one with the fewest
    idle lanes in the last round, then nv nearest NV_AIM, then the fewer
    vectors a thread.  A row no block holds walks in chunks of the
    largest block.  The choice depends on the width alone: every row
    gets its own block."""
    full = 16 // elem_bytes
    vec = full if aligned and d % full == 0 else 1
    nvec = -(-d // vec)
    nvs = [n for n in NV if vec == 1 or n > 1]
    fits = [(t, n) for n in nvs
            for t in range(MIN_THREADS, max_threads(n, vec) + 1, 32)
            if t * n >= nvec]
    if fits:
        t, n = min(fits, key=lambda tn: (tn[0] * tn[1] - nvec,
                                         abs(tn[1] - NV_AIM), tn[1]))
        return Plan(threads=t, nv=n, vec=vec, chunks=1)
    t, n = max(((max_threads(n, vec), n) for n in nvs),
               key=lambda tn: tn[0] * tn[1])
    return Plan(threads=t, nv=n, vec=vec, chunks=-(-nvec // (t * n)))


@functools.cache
def _entry():
    fn = build.load("rmsnorm").rmsnorm_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float] + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale) -> str:
    """Raises on what the kernel does not take; returns where x and
    scale are: "cuda" (one CUDA device: the common case, tested first,
    with no ``torch.device`` built), "cpu" or "meta"."""
    refuse_dtensor("rmsnorm", x, scale)
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: x and scale must be float32 or bfloat16, "
                        f"got {x.dtype} and {scale.dtype}")
    if x.dim() < 1 or scale.shape != x.shape[-1:]:
        raise ValueError(f"rmsnorm: scale must have shape (d,) = "
                         f"{tuple(x.shape[-1:])}, got {tuple(scale.shape)}")
    on_card = x.is_cuda and scale.is_cuda and \
        x.get_device() == scale.get_device()
    if not on_card:
        if scale.device != x.device:
            raise ValueError(f"rmsnorm: scale on {scale.device}, x on "
                             f"{x.device}")
        if x.device.type not in ("cpu", "meta"):
            raise ValueError(f"rmsnorm: unsupported device {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    return "cuda" if on_card else x.device.type


def cost(x: torch.Tensor, scale: torch.Tensor) -> KernelCost:
    """One call's work: x and scale read, y written once;
    OPS_PER_ELEMENT f32 operations an element of x."""
    return KernelCost(OPS_PER_ELEMENT * x.numel(), nbytes(x, x, scale))


def rmsnorm_backward(x: torch.Tensor, scale: torch.Tensor,
                     dy: torch.Tensor, eps: float = 1e-6):
    """(dx, dscale): the gradient of ``rmsnorm_ref(x, scale, eps)`` at
    ``dy``, the card path's backward."""
    return plain_backward(rmsnorm_ref, (x, scale), (dy,), eps=eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` with float32 statistics;
    output in x's type.  x: (..., d), scale: (d,)."""
    where = _check(x, scale)
    if where == "cpu":
        return rmsnorm_ref(x, scale, eps)
    return with_grad(_launch if where == "cuda" else _meta, rmsnorm_ref,
                     (x, scale), eps=eps)


def _meta(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return meta_call("rmsnorm", lambda: cost(x, scale),
                     lambda: torch.empty_like(x))


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float):
    """One launch of the kernel on checked CUDA tensors."""
    global launches
    y = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return y
    if rows > _MAX_ROWS:
        raise ValueError(f"rmsnorm: {rows} rows exceed the grid limit")
    px, ps, py = x.data_ptr(), scale.data_ptr(), y.data_ptr()
    p = plan(d, x.element_size(), (px | ps | py) % 16 == 0)
    rc = launch(_entry(), x.get_device(), px, ps, py, rows, d, float(eps),
                _DTYPES[x.dtype], _DTYPES[scale.dtype], p.threads, p.nv,
                p.vec, p.chunks)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc} "
                           f"at shape {tuple(x.shape)}")
    launches += 1
    return y
