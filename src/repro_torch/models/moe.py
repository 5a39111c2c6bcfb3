"""Mixture-of-Experts layer, in PyTorch: top-k routing with a static
per-expert capacity.

The port of ``repro.models.moe`` (GShard/MaxText-style dispatch):

  * tokens are routed within groups (a group is a batch row): a
    token-major cumsum over the flat (s, k) choices gives each choice
    its position in its expert, and choices at positions >= C are
    dropped, so earlier tokens win the slots;
  * dispatch gathers tokens into a dense (B, E, C, d) buffer through a
    pad slot S (a zero row) for the empty slots;
  * the experts run as one batched product per projection over the
    expert axis (``torch.bmm``; the reference's ``jnp.einsum``, no
    Pallas kernel);
  * outputs are combined with the renormalised router gates;
  * DeepSeekMoE shared experts (always-on dense experts) are added to
    the routed output [arXiv:2401.06066].

Plain torch ops on any device.  Two choices keep it equal to the
reference and the same from run to run on the card:

  * top-k breaks ties toward the lower expert index, as
    ``jax.lax.top_k`` does: a stable descending ``torch.sort`` of the
    probabilities keeps equal values in index order, and its first K
    columns are the choices (``torch.topk``'s order among equal values
    is not specified on CUDA);
  * the combine gathers each token's K slots and sums them in k order,
    in float32.  The reference scatter-adds the slots into (S+1, d);
    on CUDA ``index_add_`` adds through atomics in no fixed order.

At decode (S = 1) C is 1, and every expert runs on all B rows of the
buffer, most of them pad rows: the reference's design, kept here.

On DTensors routing, dispatch and combine run per batch row on each
rank's rows (``params.local_call``, batch on ``data``, the router
replicated), and the expert products are DTensor products over the
expert-sharded weights, constrained where the reference constrains
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _act
from repro_torch.models.params import (P, constrain, dense, is_dtensor,
                                       local_call, redistribute)


def moe_schema(cfg):
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    s = {"router": P((d, E), ("embed", "experts"), scale=0.02),
         "up": P((E, d, f), ("experts", "embed", "mlp")),
         "gate": P((E, d, f), ("experts", "embed", "mlp")),
         "down": P((E, f, d), ("experts", "mlp", "embed"))}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        s["shared_up"] = P((d, fs), ("embed", "mlp"))
        s["shared_gate"] = P((d, fs), ("embed", "mlp"))
        s["shared_down"] = P((fs, d), ("mlp", "embed"))
    return s


def moe_capacity(cfg, seq_len: int, capacity_factor: float) -> int:
    E, K = cfg.num_experts, cfg.experts_per_token
    return max(1, int(seq_len * K * capacity_factor / E))


def _dispatch(cfg, x: torch.Tensor, router: torch.Tensor,
              capacity_factor: float):
    """Routing and dispatch tables: ``slot`` (B, S*K), the flat expert
    slot e*C + pos of each token's k-th choice in token-major order (E*C
    where the choice was dropped), ``disp_tok``, ``disp_gate`` and the
    load-balance loss's per-row terms (B,), before their mean."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, S, capacity_factor)

    probs = torch.softmax(x.float() @ router.float(), dim=-1)   # (B, S, E)
    gate_vals, expert_ids = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_ids = gate_vals[..., :K], expert_ids[..., :K]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(dim=1)                                      # (B, E)
    ce = F.one_hot(expert_ids, E).float().sum(dim=(1, 2)) / (S * K)
    aux_rows = (me * ce).sum(-1)

    flat_e = expert_ids.reshape(B, S * K)
    onehot = F.one_hot(flat_e, E)                               # (B, SK, E)
    pos = (onehot.cumsum(dim=1) - 1).gather(-1, flat_e[..., None])[..., 0]
    # kept choices fill distinct (e, pos) slots; dropped ones all land
    # in one spare slot at E*C, cut off below
    slot = torch.where(pos < C, flat_e * C + pos, E * C)
    flat_t = torch.arange(S, device=x.device).repeat_interleave(K)
    disp_tok = torch.full((B, E * C + 1), S, dtype=torch.int64,
                          device=x.device)
    disp_tok.scatter_(1, slot, flat_t.expand(B, -1))
    disp_gate = torch.zeros((B, E * C + 1), dtype=torch.float32,
                            device=x.device)
    disp_gate.scatter_(1, slot, gate_vals.reshape(B, S * K))
    return (slot, disp_tok[:, :-1].reshape(B, E, C),
            disp_gate[:, :-1].reshape(B, E, C), aux_rows)


def _aux(cfg, aux_rows):
    """The Switch-style load-balance loss from its per-row terms."""
    return cfg.router_aux_coef * cfg.num_experts * aux_rows.mean()


def route(cfg, x: torch.Tensor, router: torch.Tensor,
          capacity_factor: float = 1.25):
    """The reference's routing of x (B, S, d) with router (d, E).

    Returns ``disp_tok`` (B, E, C) int64: the token in each expert slot,
    S for an empty one; ``disp_gate`` (B, E, C) float32: its
    renormalised gate, 0 for an empty slot; and ``aux``, the
    Switch-style load-balance loss (per group, then averaged)."""
    _, disp_tok, disp_gate, aux_rows = _dispatch(cfg, x, router,
                                                 capacity_factor)
    return disp_tok, disp_gate, _aux(cfg, aux_rows)


def apply_moe(cfg, p, x: torch.Tensor, *, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out (B, S, d) in x's type, aux scalar).  On
    DTensors routing, dispatch and combine run on each rank's rows
    (``_per_row``) and the experts on each rank's experts, constrained
    where the reference constrains them."""
    K = cfg.experts_per_token
    x = constrain(x, ("batch", "seq", "embed"))
    slot, disp_tok, disp_gate, aux_rows = _per_row(
        lambda a, r: _dispatch(cfg, a, r, capacity_factor), 4, x,
        _replicated(p["router"]))
    expert_in = constrain(_per_row(_gather_in, 1, x, disp_tok),
                          ("batch", "experts", None, "embed"))
    act = _act(cfg.activation)
    h = _expert_mm(expert_in, p["up"]) \
        * act(_expert_mm(expert_in, p["gate"]))
    # The reference constrains h to ("batch", "experts", None, "mlp")
    # here, and its last-wins rule moves the model axis from the experts
    # to the mlp split.  Each rank's experts run whole on its rows
    # instead, so the down product needs no reduction (and no
    # all-to-all, which gloo lacks).
    expert_out = constrain(_expert_mm(h, p["down"]),
                           ("batch", "experts", None, "embed"))
    # combine: each token gathers its K slots over every expert
    weighted = constrain(expert_out.float(), ("batch", None, None, None))
    out = _per_row(lambda w, g, sl: _combine(w * g[..., None], sl, K), 1,
                   weighted, disp_gate, slot).to(x.dtype)
    out = constrain(out, ("batch", "seq", "embed"))

    if cfg.num_shared_experts:
        sh = (x @ p["shared_up"]) * act(x @ p["shared_gate"])
        out = out + sh @ p["shared_down"]
    return out, _aux(cfg, aux_rows)


def _per_row(fn, n_out: int, *args):
    """``fn(*args)``, a function of whole batch rows; on DTensors (batch
    on ``data``) each rank's rows, through ``local_call``, every
    argument whole but along its batch axis (under sequence parallelism
    a row's tokens are routed, and gathered, as one group)."""
    if not is_dtensor(args[0]):
        return fn(*args)
    args = tuple(_rows_only(a) if is_dtensor(a) else a for a in args)
    pl = tuple(args[0].placements)
    return local_call(fn, (pl,) * n_out if n_out > 1 else pl, *args)


def _rows_only(t):
    """DTensor t split along its batch axis (dim 0) only."""
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(p if isinstance(p, Shard) and p.dim % t.dim() == 0
               else Replicate() for p in t.placements)
    return t if pl == tuple(t.placements) else redistribute(t, pl)


def _replicated(t):
    """t whole on every rank (a DTensor replicated over its mesh)."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def _gather_in(x: torch.Tensor, disp_tok: torch.Tensor) -> torch.Tensor:
    """The dispatch buffer (B, E, C, d): x's token in each expert slot,
    a zero row (the pad slot S) in an empty one."""
    B, S, d = x.shape
    E, C = disp_tok.shape[1:]
    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)      # (B, S+1, d)
    rows = torch.arange(B, device=x.device)[:, None]
    return x_pad[rows, disp_tok.reshape(B, E * C)].reshape(B, E, C, d)


def _expert_mm(x, w):
    """einsum("becd,edf->becf", x, w) as one batched product over the
    experts (``torch.bmm`` of (E, B*C, d) by (E, d, f))."""
    B, E, C, d = x.shape
    xe = dense(x.transpose(0, 1)).reshape(E, B * C, d)
    return torch.bmm(xe, w).reshape(E, B, C, w.shape[-1]).transpose(0, 1)


def _combine(weighted: torch.Tensor, slot: torch.Tensor, K: int):
    """Each token gathers its K slots of ``weighted`` (B, E, C, d) (a
    dropped choice reads the zero row at E*C) and sums them in k order:
    (B, S, d) in float32."""
    B, E, C, d = weighted.shape
    S = slot.shape[1] // K
    weighted = torch.cat([weighted.reshape(B, E * C, d),
                          weighted.new_zeros((B, 1, d))], dim=1)
    rows = torch.arange(B, device=weighted.device)[:, None]
    picked = weighted[rows, slot].reshape(B, S, K, d)
    out = picked[:, :, 0]
    for k in range(1, K):
        out = out + picked[:, :, k]
    return out
