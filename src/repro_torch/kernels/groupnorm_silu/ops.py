"""Wrapper for fused GroupNorm + SiLU (NHWC).

A CPU tensor goes to the plain version (``ref.groupnorm_silu_ref``); a
CUDA tensor launches the kernel of ``csrc/groupnorm_silu.cu`` or raises.
``launches`` counts kernel launches, so a run can show that its path went
through the kernel.  There is no gradient: under grad mode a CUDA or
meta input that needs one raises.  A meta tensor gets the output's
shape and type, no arithmetic (``kernels.meta_call``); ``cost`` is a
call's work.  ``plan`` chooses the kernel's tiling for a shape: a
plain function of the shape, so that it can be checked without a card.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import (KernelCost, build, launch, meta_call,
                                 nbytes, refuse_dtensor)
from repro_torch.kernels.groupnorm_silu.ref import (groupnorm_silu_ref,
                                                    num_groups_for)

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
OPS_PER_ELEMENT = 12       # mean 1, variance 3, normalize 4, SiLU 4

SMS = 132                  # streaming multiprocessors of an H100 SXM
ROW_BYTES = (128, 64, 32)  # a slab's row per pixel: the widest that fills
                           # SMS blocks (all of C where C is narrower)
ONCHIP_BYTES = 64 * 1024   # most x bytes a block holds in registers
THREADS = 128              # threads a block aims for (measured: 256 is
                           # 2% slower a forward on the H100, PERF.md)
MAX_THREADS = 512          # the kernel's __launch_bounds__
NV = (1, 2, 4, 8, 16)      # loads a thread may hold (the kernel's templates)
NV_MAX = {4: 16, 2: 8}     # by element bytes: ptxas keeps 16 bf16 loads a
                           # thread in local memory (664 B of stack)


@dataclasses.dataclass(frozen=True)
class Plan:
    """The kernel's tiling for one call: the grid is (C / slab, B), one
    block per image and slab of whole groups, ``threads`` threads, each
    ``nv`` loads of ``vec`` elements a chunk; ``chunks`` > 1: the image
    is too large to hold and x is read again."""
    slab: int
    threads: int
    vec: int
    nv: int
    chunks: int
    blocks: int
    tile_bytes: int


def _threads(rvec: int, hw: int, nv_max: int) -> int:
    """A multiple of ``rvec`` (loads per pixel row) with no more rows than
    the image has pixels: one that holds the image in ``nv_max`` loads a
    thread where one can, then a multiple of 32, then the most up to
    THREADS, else the fewest above it."""
    top = max(1, min(hw, MAX_THREADS // rvec))
    need = min(top, -(-hw // nv_max))

    def key(m):
        t = rvec * m
        return m >= need, t % 32 == 0, t <= THREADS, t if t <= THREADS else -t
    return rvec * max(range(1, top + 1), key=key)


@functools.lru_cache(maxsize=256)     # called on every launch
def plan(batch: int, hw: int, channels: int, groups: int, elem_bytes: int,
         aligned: bool = True) -> Plan:
    """The tiling for x (batch, hw pixels, channels) in ``groups``
    contiguous groups (``groups`` divides ``channels``), elements of
    ``elem_bytes``.  ``aligned``: x's and y's addresses are 16-byte
    aligned.

    The slab is the narrowest run of whole groups with rows of at least
    ROW_BYTES[i], for the first i whose tile (hw pixels x slab) fits
    ONCHIP_BYTES and which gives SMS blocks; where none does, the one
    with the most blocks; where no tile fits, the widest rows, in
    chunks."""
    cg = channels // groups
    vec = 16 // elem_bytes if aligned and channels * elem_bytes % 16 == 0 \
        else 1
    unit = math.lcm(cg, vec)
    if unit // vec > MAX_THREADS:
        raise ValueError(
            f"groupnorm_silu: groups of {cg} channels are wider than one "
            f"block covers ({MAX_THREADS * vec} at this alignment)")
    slabs = [s for s in range(unit, channels + 1, unit)
             if channels % s == 0 and s // vec <= MAX_THREADS]
    tiers = [next((s for s in slabs if s * elem_bytes >= row), slabs[-1])
             for row in ROW_BYTES]
    fits = [s for s in tiers if hw * s * elem_bytes <= ONCHIP_BYTES]
    if fits:
        enough = [s for s in fits if batch * (channels // s) >= SMS]
        slab = enough[0] if enough else fits[-1]
    else:
        slab = tiers[0]
    rvec = slab // vec
    nv_max = NV_MAX[elem_bytes]
    threads = _threads(rvec, hw, nv_max)
    passes = -(-hw // (threads // rvec))
    nv = next((n for n in NV if n >= min(passes, nv_max)))
    return Plan(slab=slab, threads=threads, vec=vec, nv=nv,
                chunks=-(-passes // nv), blocks=batch * (channels // slab),
                tile_bytes=hw * slab * elem_bytes)


@functools.cache
def _entry():
    fn = build.load("groupnorm_silu").groupnorm_silu_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, scale, bias, num_groups):
    refuse_dtensor("groupnorm_silu", x, scale, bias)
    if x.device.type not in ("cpu", "cuda", "meta"):
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


def cost(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
         num_groups: int) -> KernelCost:
    """One call's work: x, scale and bias read, y written once;
    OPS_PER_ELEMENT f32 operations an element of x."""
    return KernelCost(OPS_PER_ELEMENT * x.numel(),
                      nbytes(x, x, scale, bias))


def groupnorm_silu(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """SiLU(GroupNorm(x) * scale + bias) with G = the largest divisor of
    C that is <= ``num_groups``; output in x's dtype."""
    global launches
    G = _check(x, scale, bias, num_groups)
    if x.device.type == "cpu":
        return groupnorm_silu_ref(x, scale, bias, num_groups, eps)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        raise NotImplementedError(
            "groupnorm_silu: the kernel has no backward (nor has the TPU "
            "kernel it replaces); call it under torch.no_grad() or on "
            "inputs that need no gradient")
    if x.device.type == "meta":
        return meta_call("groupnorm_silu",
                         lambda: cost(x, scale, bias, num_groups),
                         lambda: torch.empty_like(x))
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    p = plan(B, H * W, C, G, x.element_size(),
             aligned=x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0)
    rc = launch(_entry(), x.get_device(), x.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), B, H * W, C, G, float(eps),
                _DTYPES[x.dtype], p.slab, p.threads, p.vec, p.nv)
    if rc != 0:
        raise RuntimeError(f"groupnorm_silu kernel launch failed: CUDA "
                           f"error {rc} at shape {tuple(x.shape)}")
    launches += 1
    return y
