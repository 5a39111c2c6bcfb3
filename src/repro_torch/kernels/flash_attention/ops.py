"""Wrapper for forward flash attention.

A CPU tensor goes to the plain version (``ref.attention_ref``); a CUDA
tensor launches the kernel of ``csrc/flash_attention.cu`` (which loads
16-byte chunks, so q, k and v must be 16-byte aligned) or raises.
Under grad mode, when q, k or v needs a gradient, the launch goes
through ``kernels.KernelFunction``: the kernel's forward, and as
backward the plain version's autograd recomputed from the saved inputs
(``flash_attention_backward``), since the TPU kernel has no backward to
port.
``launches`` counts kernel launches, so a run can show that its path
went through the kernel.  A meta tensor gets the output's shape and
type, no arithmetic (``kernels.meta_call``); ``cost`` is a call's work.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from repro_torch.kernels import (KernelCost, build, launch, meta_call,
                                 nbytes, plain_backward, product_rate,
                                 refuse_dtensor, with_grad)
from repro_torch.kernels.flash_attention.ref import attention_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 80, 128)        # the kernel's compiled head sizes
_MAX_GRID_YZ = 65535


@functools.cache
def _entry():
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, causal, window, q_offset):
    refuse_dtensor("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B,Sq,H,D) and k, v "
                         f"(B,Skv,KV,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    _, Skv, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D or KV < 1 or H % KV:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} do not fit (H = KV * G)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if q_offset is None and Sq > Skv and (causal or window):
        raise ValueError(f"flash_attention: Sq={Sq} > Skv={Skv} with a "
                         f"causal or window mask and ends aligned (no "
                         f"q_offset): the first query would sit before "
                         f"the first key")
    if q_offset is not None and q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one type, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B={B} or H={H} over the grid "
                         f"limit {_MAX_GRID_YZ}")


def pairs(Sq: int, Skv: int, causal: bool = True, window: int = 0,
          q_offset=None) -> int:
    """The (query, key) pairs the mask leaves: query i at key position
    i + q_offset (default Skv - Sq) sees key j where j <= its position
    (``causal``) and its position - j < ``window`` (when set)."""
    if not (causal or window):
        return Sq * Skv
    pos = np.arange(Sq, dtype=np.int64) + (Skv - Sq if q_offset is None
                                           else q_offset)
    hi = np.minimum(pos, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(pos - window + 1, 0) if window else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def cost(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: int = 0, q_offset=None) -> KernelCost:
    """One call's work: q, k, v read and o (q's shape and type) written
    once, against 4 D operations (q.k and p.v) per (query, key) pair the
    mask leaves (``pairs``) and head, at the rate of q's type
    (``product_rate``): float32 as TF32_PER_F32_OP tensor-core
    operations at TF32_OPS_PER_S (3xTF32), bfloat16 one operation at
    BF16_OPS_PER_S.  The kernel runs a bfloat16 call on TF32 tensor
    cores (hi*hi for q.k, two products for p.v: 1.5 per operation at
    TF32_OPS_PER_S), so its own floor is 3x this bound's operations
    term."""
    B, Sq, H, D = q.shape
    n = pairs(Sq, k.shape[1], causal, window, q_offset)
    return KernelCost(4 * D * n * B * H, nbytes(q, q, k, v),
                      *product_rate(q, k, v))


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int = 0):
    """(dq, dk, dv), dk and dv in the GQA layout (B,Skv,KV,D): the
    gradient of ``attention_ref`` at ``do``, the card path's backward.
    It holds the (B,H,Sq,Skv) float32 scores while it runs."""
    return plain_backward(attention_ref, (q, k, v), (do,), causal=causal,
                          window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset=None) -> torch.Tensor:
    """Softmax attention of q (B,Sq,H,D) over k, v (B,Skv,KV,D), query
    head h reading KV head h // (H/KV); query i sits at key position
    i + q_offset, by default i + Skv - Sq (ends aligned, the Pallas
    kernel's rule), which only a causal or window mask reads: without
    one (cross attention) Sq may exceed Skv, and with an explicit
    q_offset >= 0 (continuation attention) too.  f32 scores and
    accumulation; output in q's type."""
    _check(q, k, v, causal, window, q_offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    return with_grad(_launch if q.device.type == "cuda" else _meta,
                     attention_ref, (q, k, v), causal=causal,
                     window=window, q_offset=q_offset)


def _meta(q, k, v, causal, window, q_offset=None):
    return meta_call("flash_attention",
                     lambda: cost(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset),
                     lambda: torch.empty_like(q))


def _launch(q, k, v, causal, window, q_offset=None):
    """One launch of the kernel on checked CUDA tensors."""
    global launches
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) % 16:
        raise ValueError("flash_attention: q, k and v must start on a "
                         "16-byte boundary (the kernel loads 16-byte "
                         "chunks)")
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    # the kernel reads q_offset only through a causal or window mask
    if not (causal or window):
        q_offset = 0
    elif q_offset is None:
        q_offset = Skv - Sq
    rc = launch(_entry(), q.get_device(), qp, kp, vp, o.data_ptr(), B, Sq, Skv,
                H, KV, D, int(bool(causal)), int(window), q_offset,
                1.0 / math.sqrt(D), _DTYPES[q.dtype])
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}")
    launches += 1
    return o
