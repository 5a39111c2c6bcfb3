"""xLSTM blocks [arXiv:2405.04517] in PyTorch: mLSTM (matrix memory,
parallel over the sequence) and sLSTM (scalar memory, a recurrence over
time).

The port of ``repro.models.xlstm``.  The mLSTM recurrence

    C_t = f_t C_{t-1} + i_t v_t k_t^T ,   n_t = f_t n_{t-1} + i_t k_t
    y_t = C_t q_t / max(|n_t . q_t|, 1)

is the SSD form with per-head B/C (k and q), so prefill runs
``ssm.ssd_chunked``'s per-head branch (plain torch: the TPU kernel never
took that form), the normalizer ``n`` riding along as a ones channel of
v: a state of (B, H, Dh + 1, Dh) in float32.  The reference's
stabilization is kept as it is: the input gate is exp(clip(i, -8, 8)),
the forget gate a log-sigmoid.

sLSTM: per-head block-diagonal recurrent mixing and stabilized exp
gating, a Python loop over time (inherently sequential, the
reference's ``lax.scan``).  Both blocks' inner norms go through the
RMSNorm kernel's wrapper: one call a block per forward or step.

Under a device mesh the mLSTM's conv runs on its ``ssm_inner``
channels, the row-split products are reduced, and the per-head scan
runs on whole heads on each rank's rows; the sLSTM (its FFN replicated:
``mlp`` resolves to None for xLSTM, as in the reference) runs its time
loop on each rank's rows through ``params.local_call``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rmsnorm
from repro_torch.models.params import (P, constrain, elementwise,
                                       is_dtensor, local_call, zeros)
from repro_torch.models.ssm import causal_conv, ssd_chunked

# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    return d_in, H, d_in // H


def mlstm_schema(cfg):
    d = cfg.d_model
    d_in, H, _ = mlstm_dims(cfg)
    W = 4
    return {
        "up": P((d, 2 * d_in), ("embed", "ssm_inner")),
        "conv_w": P((W, d_in), (None, None), scale=0.5),
        "conv_b": P((d_in,), (None,), init="zeros"),
        "wq": P((d_in, d_in), ("ssm_inner", None)),
        "wk": P((d_in, d_in), ("ssm_inner", None)),
        "wv": P((d_in, d_in), ("ssm_inner", None)),
        "wi": P((d_in, H), ("ssm_inner", None), scale=0.02),
        "wf": P((d_in, H), ("ssm_inner", None), scale=0.02),
        "bi": P((H,), (None,), init="zeros"),
        "bf": P((H,), (None,), init="ones"),   # bias toward remembering
        "norm": P((d_in,), (None,), init="ones"),
        "down": P((d_in, d), ("ssm_inner", "embed")),
    }


def _mlstm_qkvif(cfg, p, u, conv_state=None):
    """The mLSTM's projections.  Under a mesh the conv runs on the
    rank's ``ssm_inner`` channels (its state sharded so), and the
    row-split products with wq, wk, wv, wi and wf come out Partial and
    are reduced at once: the heads' scan reads them whole."""
    B, S, _ = u.shape
    d_in, H, Dh = mlstm_dims(cfg)
    x, z = (u @ p["up"]).chunk(2, dim=-1)
    x = constrain(x, ("batch", "seq", "ssm_inner"))
    if conv_state is not None:
        conv_state = constrain(conv_state, ("batch", None, "ssm_inner"))
    # causal depthwise conv on the mLSTM input path
    xc, new_conv = causal_conv(p["conv_w"], p["conv_b"], x, conv_state,
                               "ssm_inner")

    def whole(t):                       # a row-split product, reduced
        return constrain(t, ("batch", "seq", None))

    q = whole(xc @ p["wq"]).reshape(B, S, H, Dh)
    k = whole(xc @ p["wk"]).reshape(B, S, H, Dh) / (Dh ** 0.5)
    v = whole(x @ p["wv"]).reshape(B, S, H, Dh)
    logf = elementwise(F.logsigmoid, (whole(xc @ p["wf"]) + p["bf"]).float())
    i_gate = torch.exp(torch.clamp((whole(xc @ p["wi"]) + p["bi"]).float(),
                                   -8.0, 8.0))
    return x, z, q, k, v, logf, i_gate, new_conv


def mlstm_forward(cfg, p, u, state=None, *, chunk: int = 128):
    """u: (B, S, d) -> (y, new_state).  Under a mesh the per-head scan
    runs on whole heads (``cache_pspecs`` replicates the memory over
    ``model``)."""
    B, S, _ = u.shape
    d_in, H, Dh = mlstm_dims(cfg)
    conv_in = state["conv"] if state is not None else None
    _, z, q, k, v, logf, i_gate, new_conv = _mlstm_qkvif(cfg, p, u, conv_in)
    # v extended with a ones channel: the scan also produces n . q
    v_ext = torch.cat([v.float() * i_gate[..., None], i_gate[..., None]],
                      dim=-1)                               # (B,S,H,Dh+1)
    h0 = state["mem"] if state is not None else zeros(
        (B, H, Dh + 1, Dh), u, ("batch", None, None, None))
    y_ext, h_fin = ssd_chunked(v_ext, logf, k, q, h0, chunk=chunk)
    y, nq = y_ext[..., :Dh], y_ext[..., Dh:]
    y = (y / torch.clamp(nq.abs(), min=1.0)).reshape(B, S, d_in).to(u.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"])
    return y @ p["down"], {"conv": new_conv, "mem": h_fin}


def mlstm_step(cfg, p, u, state):
    """Single decode step; u: (B, 1, d)."""
    B = u.shape[0]
    d_in, H, Dh = mlstm_dims(cfg)
    _, z, q, k, v, logf, i_gate, new_conv = _mlstm_qkvif(
        cfg, p, u, state["conv"])
    f = torch.exp(logf[:, 0])                               # (B,H)
    iv = v[:, 0].float() * i_gate[:, 0][..., None]
    v_ext = torch.cat([iv, i_gate[:, 0][..., None]], dim=-1)
    h = state["mem"] * f[..., None, None] \
        + torch.einsum("bhp,bhn->bhpn", v_ext, k[:, 0].float())
    y_ext = torch.einsum("bhpn,bhn->bhp", h, q[:, 0].float())
    y, nq = y_ext[..., :Dh], y_ext[..., Dh:]
    y = (y / torch.clamp(nq.abs(), min=1.0)).reshape(B, 1, d_in)
    y = rmsnorm(y.to(u.dtype) * F.silu(z), p["norm"])
    return y @ p["down"], {"conv": new_conv, "mem": h}


def mlstm_init_state(cfg, batch: int, dtype=torch.float32, device="cuda"):
    d_in, H, Dh = mlstm_dims(cfg)
    return {"conv": torch.zeros((batch, 3, d_in), dtype=dtype,
                                device=device),
            "mem": torch.zeros((batch, H, Dh + 1, Dh), dtype=torch.float32,
                               device=device)}


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------

GATES = ("i", "f", "z", "o")


def slstm_schema(cfg):
    d = cfg.d_model
    H = cfg.num_heads
    Dh = d // H
    d_ff = int(round(4 * d / 3 / 64)) * 64 or 64     # paper's 4/3 post-FFN
    gates = {}
    for g in GATES:
        gates[f"w{g}"] = P((d, d), ("embed", None), scale=0.02)
        gates[f"r{g}"] = P((H, Dh, Dh), (None, None, None), scale=0.02)
        gates[f"b{g}"] = P((d,), (None,),
                           init="ones" if g == "f" else "zeros")
    return {
        **gates,
        "norm": P((d,), (None,), init="ones"),
        "ffn_up": P((d, d_ff), ("embed", "mlp")),
        "ffn_gate": P((d, d_ff), ("embed", "mlp")),
        "ffn_down": P((d_ff, d), ("mlp", "embed")),
    }


def _slstm_cell(cfg, p, xt, carry):
    """One sLSTM step.  xt: {gate: (B, d)} pre-activations, W x + b
    already in; carry = (c, n, h, m), each (B, d)."""
    B, d = xt["i"].shape
    H = cfg.num_heads
    c, n, h, m = carry
    hh = h.reshape(B, H, d // H)

    def rec(g):
        # jnp.einsum promotes: the f32 carry meets bf16 weights in f32
        r = p[f"r{g}"]
        dt = torch.promote_types(hh.dtype, r.dtype)
        return torch.einsum("bhx,hxy->bhy", hh.to(dt), r.to(dt)).reshape(
            B, d)

    it = xt["i"] + rec("i")
    ft = xt["f"] + rec("f")
    zt = torch.tanh(xt["z"] + rec("z"))
    ot = torch.sigmoid(xt["o"] + rec("o"))
    logf = F.logsigmoid(ft)
    m_new = torch.maximum(logf + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(logf + m - m_new)
    c_new = f_p * c + i_p * zt
    n_new = f_p * n + i_p
    h_new = ot * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_ffn(p, y):
    return ((y @ p["ffn_up"]) * F.silu(y @ p["ffn_gate"])) @ p["ffn_down"]


def _slstm_run(cfg, r, pre, carry):
    """The cell step by step over the S steps of pre ({gate: (B, S, d)},
    W x + b in); r: the recurrent weights {"r<gate>"}; carry (c, n, h,
    m) or None (zeros).  Returns (hs (B, S, d), carry).  On DTensors
    (whole rows, batch split on ``data``) each rank runs its rows'
    loop on local tensors (``local_call``): no op of the loop pays
    DTensor's dispatch."""
    if is_dtensor(pre["i"]):
        pre = {g: constrain(t, ("batch", "seq", None))
               for g, t in pre.items()}
        pl = tuple(pre["i"].placements)        # (B, ...) rows on "data"
        hs, *carry = local_call(
            lambda *a: _flat(_slstm_run(cfg, *a)), (pl,) * 5, r, pre, carry)
        return hs, tuple(carry)
    S = pre["i"].shape[1]
    if carry is None:
        carry = _slstm_zero(cfg, pre["i"].shape[0], pre["i"].device)
    hs = []
    for t in range(S):
        carry, h = _slstm_cell(cfg, r, {g: pre[g][:, t] for g in GATES},
                               carry)
        hs.append(h)
    return torch.stack(hs, dim=1), carry


def _flat(out):
    hs, carry = out
    return (hs,) + tuple(carry)


def _recurrent(p):
    return {f"r{g}": p[f"r{g}"] for g in GATES}


def slstm_forward(cfg, p, u, state=None):
    """u: (B, S, d) -> (y, new_state): the cell step by step over S."""
    pre = {g: (u @ p[f"w{g}"] + p[f"b{g}"]).float() for g in GATES}
    hs, carry = _slstm_run(cfg, _recurrent(p), pre,
                           state["cell"] if state is not None else None)
    y = rmsnorm(hs.to(u.dtype), p["norm"])
    return _slstm_ffn(p, y), {"cell": carry}


def slstm_step(cfg, p, u, state):
    pre = {g: (u[:, 0] @ p[f"w{g}"] + p[f"b{g}"]).float()[:, None]
           for g in GATES}
    h, carry = _slstm_run(cfg, _recurrent(p), pre, state["cell"])
    y = rmsnorm(h.to(u.dtype), p["norm"])
    return _slstm_ffn(p, y), {"cell": carry}


def _slstm_zero(cfg, batch: int, device="cuda"):
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return (z, z, z, z)


def slstm_init_state(cfg, batch: int, device="cuda"):
    return {"cell": _slstm_zero(cfg, batch, device)}
