"""Mamba2 (SSD) block, in PyTorch: chunked scan for prefill, recurrence
for decode.

The port of ``repro.models.ssm`` (single B/C group, G=1):

    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * x_t  (outer) B_t     (H, P, N)
    y_t = C_t . h_t + D_h * x_t

Prefill runs ``ssd_chunked``: chunks of Q steps, the masked-decay
quadratic form inside a chunk, the state carried across chunks.  Its
shared-B/C form goes through the ``ssd_scan`` kernel's wrapper (a CPU
tensor takes the plain version, a CUDA tensor the hand-written kernel);
the per-head form (xLSTM's mLSTM) is the reference's jnp branch in
plain torch ops on every device: it was never a TPU kernel.  Decode is the
O(1) recurrence in plain torch ops, as the reference gave it no kernel.
Leaves keep the reference's layouts (``in_zx (d, 2 d_in)``, ``conv_w
(W, C)``, ``out (d_in, d)``).

Under a device mesh (DTensors, the rules installed) x and z are split
on ``ssm_inner`` (``in_zx`` is column-split), B, C and dt stay whole
(``in_bcdt`` is replicated): the conv runs on x's channels and on B/C's
apart, the conv state stays whole (x's tail gathered), dt and its decay
are cut to the rank's heads, and ``ssd_chunked`` reaches the kernel's
wrapper on each rank's block through ``params.local_call`` (heads on
``model``, the state with them); the per-head scan runs there on whole
heads.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import (P, constrain, is_dtensor,
                                       local_call, zeros)

NEG_INF = -1e30


def ssm_dims(cfg) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_state


def mamba2_schema(cfg):
    d = cfg.d_model
    d_in, H, N = ssm_dims(cfg)
    W = cfg.ssm_conv
    conv_ch = d_in + 2 * N
    return {
        "in_zx": P((d, 2 * d_in), ("embed", "ssm_inner")),
        "in_bcdt": P((d, 2 * N + H), ("embed", None)),
        "conv_w": P((W, conv_ch), (None, None), scale=0.5),
        "conv_b": P((conv_ch,), (None,), init="zeros"),
        "A_log": P((H,), (None,), init="zeros"),
        "dt_bias": P((H,), (None,), init="zeros"),
        "D": P((H,), (None,), init="ones"),
        "norm": P((d_in,), (None,), init="ones"),
        "out": P((d_in, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg, p, u):
    """u: (B, S, d) -> z, x (each (B, S, d_in), split on ``ssm_inner``
    under a mesh), B and C (B, S, 2N), dt (B, S, H), each whole."""
    d_in, H, N = ssm_dims(cfg)
    z, x = (u @ p["in_zx"]).chunk(2, dim=-1)               # (B,S,d_in) each
    bc, dt = (u @ p["in_bcdt"]).split([2 * N, H], dim=-1)
    return (constrain(z, ("batch", "seq", "ssm_inner")),
            constrain(x, ("batch", "seq", "ssm_inner")), bc, dt)


def causal_conv(w, b, xs, conv_state=None, channels=None):
    """Depthwise causal conv, width W, of weights w (W, C) and bias b
    (C,).  xs: (B, S, C), its channels on the logical axis
    ``channels``.  conv_state: (B, W-1, C) previous inputs (decode) or
    None (prefill).  Returns (out, new_conv_state); the new state is in
    xs's type, whatever the type of the state passed in, as in the
    reference."""
    W = w.shape[0]
    S = xs.shape[1]
    if conv_state is None:
        pad = zeros((xs.shape[0], W - 1, xs.shape[2]), xs,
                    ("batch", None, channels), xs.dtype)
    else:
        pad = conv_state.to(xs.dtype)
    full = torch.cat([pad, xs], dim=1)                      # (B, S+W-1, C)
    out = sum(full[:, i:i + S] * w[i] for i in range(W))
    return F.silu(out + b), full[:, -(W - 1):]


def _conv(cfg, p, x, bc, conv_state=None):
    """The reference's causal conv over the channels (x, B, C), run as
    two convs: x's channels (split on ``ssm_inner`` under a mesh, the
    weights' columns with them) and B/C's (whole).  The state stays the
    reference's (B, W-1, d_in + 2N), x's part gathered under a mesh
    (``cache_pspecs`` replicates it over ``model``).  Returns (x, B, C,
    new state)."""
    d_in, _, N = ssm_dims(cfg)
    w_x, w_bc = p["conv_w"].split([d_in, 2 * N], dim=-1)
    b_x, b_bc = p["conv_b"].split([d_in, 2 * N], dim=-1)
    st_x = st_bc = None
    if conv_state is not None:
        st_x, st_bc = conv_state.split([d_in, 2 * N], dim=-1)
        st_x = constrain(st_x, ("batch", None, "ssm_inner"))
    x, tail_x = causal_conv(w_x, b_x, x, st_x, "ssm_inner")
    bc, tail_bc = causal_conv(w_bc, b_bc, bc, st_bc)
    bmat, cmat = bc.chunk(2, dim=-1)
    tail = torch.cat([constrain(tail_x, ("batch", None, None)), tail_bc],
                     dim=-1)
    return x, bmat, cmat, tail


def ssd_chunked(xh, dt_a, bmat, cmat, h0, *, chunk: int = 128):
    """Chunked SSD scan.

    xh:   (B, S, H, P)   inputs (already scaled by dt)
    dt_a: (B, S, H)      per-step log decay (dt * A, negative)
    bmat, cmat: (B, S, N) shared across heads (Mamba2 G=1), through the
                ssd_scan kernel's wrapper, or (B, S, H, N) per head (the
                mLSTM's keys and queries), in plain torch ops
    h0:   (B, H, P, N)   incoming state
    Returns y (B, S, H, P), h_final (float32).  S must be a multiple of
    min(chunk, S)."""
    S = xh.shape[1]
    Q = min(chunk, S)
    assert S % Q == 0
    if is_dtensor(xh):
        # each rank's block: the shared-B/C kernel on the rank's heads
        # (B/C whole), the per-head scan on whole heads
        return local_call(lambda *a: ssd_chunked(*a, chunk=chunk),
                          (tuple(xh.placements), tuple(h0.placements)),
                          xh, dt_a, bmat, cmat, h0)
    if bmat.dim() == 4:
        return _ssd_chunked_per_head(xh, dt_a, bmat, cmat, h0, Q)
    return ssd_ops.ssd_scan(xh.contiguous(), dt_a.contiguous(),
                            bmat.contiguous(), cmat.contiguous(),
                            h0.float().contiguous(), chunk=Q)


def _ssd_chunked_per_head(xh, dt_a, bmat, cmat, h0, Q: int):
    """The reference's jnp scan with per-head B/C, chunk by chunk: the
    incoming state's decayed contribution, the masked-decay quadratic
    form inside the chunk, and the state carried on.  Sums in float32;
    y in xh's type."""
    B, S, H, Pd = xh.shape
    h = h0.float()
    idx = torch.arange(Q, device=xh.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]    # k <= q
    ys = []
    for c0 in range(0, S, Q):
        x32 = xh[:, c0:c0 + Q].float()                      # (B,Q,H,P)
        b_ = bmat[:, c0:c0 + Q].float()                     # (B,Q,H,N)
        c_ = cmat[:, c0:c0 + Q].float()
        cum = torch.cumsum(dt_a[:, c0:c0 + Q].float(), dim=1)   # (B,Q,H)
        total = cum[:, -1]                                  # (B,H)
        y_off = torch.einsum("bqhn,bhpn->bqhp", c_, h) \
            * torch.exp(cum)[..., None]
        scores = torch.einsum("bqhn,bkhn->bqkh", c_, b_)    # (B,Q,Q,H)
        logdec = (cum[:, :, None, :] - cum[:, None, :, :]).masked_fill(
            ~tri, NEG_INF)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores * torch.exp(logdec),
                              x32)
        w = torch.exp(total[:, None] - cum)                 # (B,Q,H)
        h = h * torch.exp(total)[..., None, None] \
            + torch.einsum("bqhp,bqhn,bqh->bhpn", x32, b_, w)
        ys.append((y_off + y_diag).to(xh.dtype))
    return torch.cat(ys, dim=1), h


def mamba2_forward(cfg, p, u, state=None, *, chunk: int = 128):
    """Full-sequence forward.  u: (B, S, d).
    state: None (fresh) or dict(conv, ssm) for continued prefill.
    Returns y (B, S, d), new_state."""
    B, S, _ = u.shape
    d_in, H, N = ssm_dims(cfg)
    Pd = cfg.ssm_head_dim

    z, x, bc, dt = _split_proj(cfg, p, u)
    x, bmat, cmat, conv_state = _conv(
        cfg, p, x, bc, state["conv"] if state is not None else None)

    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,S,H)
    dt = constrain(dt, ("batch", "seq", "ssm_inner"))       # rank's heads
    a = -torch.exp(p["A_log"].float())                      # (H,) < 0
    dt_a = dt * a                                           # log decay

    xh = x.reshape(B, S, H, Pd)
    xh_dt = xh.float() * dt[..., None]
    h0 = state["ssm"] if state is not None else zeros(
        (B, H, Pd, N), u, ("batch", "ssm_inner", None, None))
    y, h_fin = ssd_chunked(xh_dt, dt_a, bmat, cmat, h0, chunk=chunk)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(u.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    out = (y @ p["out"]).to(u.dtype)
    return out, {"conv": conv_state, "ssm": h_fin}


def mamba2_step(cfg, p, u, state):
    """Single decode step.  u: (B, 1, d).  Returns y (B,1,d), new state."""
    B = u.shape[0]
    d_in, H, N = ssm_dims(cfg)
    Pd = cfg.ssm_head_dim

    z, x, bc, dt = _split_proj(cfg, p, u)
    x, bmat, cmat, conv_state = _conv(cfg, p, x, bc, state["conv"])

    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,1,H)
    dt = constrain(dt, ("batch", "seq", "ssm_inner"))
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt[:, 0] * a)                         # (B,H)

    x32 = x[:, 0].reshape(B, H, Pd).float()
    xh = x32 * dt[:, 0, :, None]
    h = state["ssm"] * decay[..., None, None] \
        + xh[..., None] * bmat[:, 0].float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), h)
    y = y + x32 * p["D"][None, :, None]
    y = y.reshape(B, d_in)[:, None].to(u.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    return y @ p["out"], {"conv": conv_state, "ssm": h}


def mamba2_init_state(cfg, batch: int, dtype=torch.float32, device="cuda"):
    d_in, H, N = ssm_dims(cfg)
    W = cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, W - 1, d_in + 2 * N), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, cfg.ssm_head_dim, N),
                           dtype=torch.float32, device=device),
    }
