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
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import P

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
    """u: (B, S, d) -> z, xBC (pre-conv), dt."""
    d_in, H, N = ssm_dims(cfg)
    z, x = (u @ p["in_zx"]).chunk(2, dim=-1)               # (B,S,d_in) each
    bmat, cmat, dt = (u @ p["in_bcdt"]).split([N, N, H], dim=-1)
    return z, torch.cat([x, bmat, cmat], dim=-1), dt


def _causal_conv(p, xbc, conv_state=None):
    """Depthwise causal conv, width W.  xbc: (B, S, C).
    conv_state: (B, W-1, C) previous inputs (decode) or None (prefill).
    Returns (out, new_conv_state); the new state is in xbc's type,
    whatever the type of the state passed in, as in the reference."""
    W = p["conv_w"].shape[0]
    S = xbc.shape[1]
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)                     # (B, S+W-1, C)
    out = sum(full[:, i:i + S] * p["conv_w"][i] for i in range(W))
    return F.silu(out + p["conv_b"]), full[:, -(W - 1):]


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

    z, xbc, dt = _split_proj(cfg, p, u)
    conv_in = state["conv"] if state is not None else None
    xbc, conv_state = _causal_conv(p, xbc, conv_in)
    x, bmat, cmat = xbc.split([d_in, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,S,H)
    a = -torch.exp(p["A_log"].float())                      # (H,) < 0
    dt_a = dt * a                                           # log decay

    xh = x.reshape(B, S, H, Pd)
    xh_dt = xh.float() * dt[..., None]
    h0 = state["ssm"] if state is not None \
        else u.new_zeros((B, H, Pd, N), dtype=torch.float32)
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

    z, xbc, dt = _split_proj(cfg, p, u)
    xbc, conv_state = _causal_conv(p, xbc, state["conv"])
    x, bmat, cmat = xbc.split([d_in, N, N], dim=-1)

    dt = F.softplus(dt.float() + p["dt_bias"])              # (B,1,H)
    a = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt[:, 0] * a)                         # (B,H)

    x32 = x.reshape(B, H, Pd).float()
    xh = x32 * dt[:, 0, :, None]
    h = state["ssm"] * decay[..., None, None] \
        + xh[..., None] * bmat[:, 0].float()[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), h)
    y = y + x32 * p["D"][None, :, None]
    y = y.reshape(B, 1, d_in).to(u.dtype)
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
