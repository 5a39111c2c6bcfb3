"""Wrapper for the chunked SSD (Mamba2) scan, shared-B/C form.

A CPU tensor goes to the plain version (``ref.ssd_scan_ref``); a CUDA
tensor launches the kernel of ``csrc/ssd_scan.cu`` or raises.  The
per-head (4-D B/C) form serves xLSTM only; the TPU kernel never took
it, and ``models.ssm.ssd_chunked`` runs it in plain torch ops.
Under grad mode, when an input needs a gradient, the launch goes through
``kernels.KernelFunction``: the kernel's forward, and as backward the plain
version's autograd recomputed from the saved inputs
(``ssd_scan_backward``), since the TPU kernel has no backward to port.
``launches`` counts kernel launches, so a run can show that its path
went through the kernel.  A meta tensor gets the outputs' shapes and
types, no arithmetic (``kernels.meta_call``); ``cost`` is a call's work.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import (TF32_OPS_PER_S, TF32_PER_F32_OP,
                                 KernelCost, build, launch, meta_call,
                                 nbytes, plain_backward, refuse_dtensor,
                                 with_grad)
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _entry():
    fn = build.load("ssd_scan").ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, a, bmat, cmat, h0, chunk):
    refuse_dtensor("ssd_scan", x, a, bmat, cmat, h0)
    if bmat.dim() == 4 or cmat.dim() == 4:
        raise NotImplementedError(
            "ssd_scan: per-head (B,S,H,N) B/C (the xLSTM form) is not "
            "this kernel's, nor was it the TPU kernel's; "
            "models.ssm.ssd_chunked runs it in plain torch.  The kernel "
            "takes B/C shared across heads, (B,S,N)")
    if x.dim() != 4 or a.dim() != 3 or bmat.dim() != 3 or h0.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B,S,H,P), a (B,S,H), "
                         f"bmat/cmat (B,S,N), h0 (B,H,P,N); got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(h0.shape)}")
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    if a.shape != (B, S, H) or bmat.shape != (B, S, N) \
            or cmat.shape != bmat.shape or h0.shape != (B, H, P, N):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, bmat {tuple(bmat.shape)}, "
                         f"cmat {tuple(cmat.shape)}, h0 {tuple(h0.shape)} "
                         f"do not fit")
    if S < 1 or chunk < 1 or S % min(chunk, S):
        raise ValueError(f"ssd_scan: S={S} must be a positive multiple of "
                         f"min(chunk, S) = {min(chunk, S)}")
    if x.dtype not in _DTYPES or a.dtype not in _DTYPES \
            or bmat.dtype not in _DTYPES or cmat.dtype != bmat.dtype:
        raise TypeError(f"ssd_scan: x, a, bmat/cmat must be float32 or "
                        f"bfloat16, bmat and cmat of one type; got "
                        f"{x.dtype}, {a.dtype}, {bmat.dtype}, {cmat.dtype}")
    if h0.dtype != torch.float32:
        raise TypeError(f"ssd_scan: h0 must be float32, got {h0.dtype}")
    if any(t.device != x.device for t in (a, bmat, cmat, h0)):
        raise ValueError("ssd_scan: inputs on different devices")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, a, bmat, cmat, h0)):
        raise ValueError("ssd_scan: inputs must be contiguous")


def cost(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
         cmat: torch.Tensor, h0: torch.Tensor, *,
         chunk: int = 128) -> KernelCost:
    """One call's work, chunks of Q = min(chunk, S): x, a, B, C and h0
    read, y and h_final written once, against the f32 operations, each
    TF32_PER_F32_OP tensor-core operations at TF32_OPS_PER_S (all four
    products run on 3xTF32; h0 and the state are float32 at every x
    type, so the products keep float32 precision).  Per (b, h) and chunk: 2QPN for C h^T and
    2QPN for the state update; per causal (q, k) pair a decay multiply
    and 2P for the product with x.  The scores C B^T are the same for
    every head, so the function needs their 2N per pair once per batch
    row."""
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    Q = min(chunk, S)
    pairs = B * (S // Q) * Q * (Q + 1) // 2
    flops = (B * H * (S // Q) * 4 * Q * P * N + (2 * P + 1) * H * pairs
             + 2 * N * pairs)
    return KernelCost(flops, nbytes(x, x, bmat, cmat, h0, h0, a),
                      TF32_OPS_PER_S, TF32_PER_F32_OP)


def ssd_scan_backward(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                      cmat: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
                      dh: torch.Tensor, *, chunk: int = 128):
    """(dx, da, dbmat, dcmat, dh0): the gradient of ``ssd_scan_ref`` at
    (dy, dh) for its outputs (y, h_final), the card path's backward."""
    return plain_backward(ssd_scan_ref, (x, a, bmat, cmat, h0), (dy, dh),
                          chunk=chunk)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
             cmat: torch.Tensor, h0: torch.Tensor, *, chunk: int = 128):
    """x (B,S,H,P); a (B,S,H) log-decay; bmat, cmat (B,S,N) shared
    across heads; h0 (B,H,P,N) float32.  Chunks of Q = min(chunk, S)
    steps, S a multiple of Q.  float32 arithmetic.  Returns y (B,S,H,P)
    in x's type and h_final (B,H,P,N) float32."""
    _check(x, a, bmat, cmat, h0, chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, a, bmat, cmat, h0, chunk=chunk)
    return with_grad(_launch if x.device.type == "cuda" else _meta,
                     ssd_scan_ref, (x, a, bmat, cmat, h0), chunk=chunk)


def _meta(x, a, bmat, cmat, h0, chunk):
    return meta_call("ssd_scan",
                     lambda: cost(x, a, bmat, cmat, h0, chunk=chunk),
                     lambda: (torch.empty_like(x), torch.empty_like(h0)))


def _launch(x, a, bmat, cmat, h0, chunk):
    """One launch of the kernel on checked CUDA tensors."""
    global launches
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    Q = min(chunk, S)
    y = torch.empty_like(x)
    h_fin = torch.empty_like(h0)
    if x.numel() == 0:
        return y, h_fin
    rc = launch(_entry(), x.get_device(), x.data_ptr(), a.data_ptr(),
                bmat.data_ptr(), cmat.data_ptr(), h0.data_ptr(),
                y.data_ptr(), h_fin.data_ptr(), B, S, H, P, N, Q,
                _DTYPES[x.dtype], _DTYPES[a.dtype], _DTYPES[bmat.dtype])
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc} "
                           f"at x {tuple(x.shape)}, N={N}, chunk {Q}")
    launches += 1
    return y, h_fin
