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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _act
from repro_torch.models.params import P


def moe_schema(cfg):
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    s = {"router": P((d, E), scale=0.02),
         "up": P((E, d, f)), "gate": P((E, d, f)), "down": P((E, f, d))}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        s["shared_up"] = P((d, fs))
        s["shared_gate"] = P((d, fs))
        s["shared_down"] = P((fs, d))
    return s


def moe_capacity(cfg, seq_len: int, capacity_factor: float) -> int:
    E, K = cfg.num_experts, cfg.experts_per_token
    return max(1, int(seq_len * K * capacity_factor / E))


def _dispatch(cfg, x: torch.Tensor, router: torch.Tensor,
              capacity_factor: float):
    """Routing and dispatch tables: ``slot`` (B, S*K), the flat expert
    slot e*C + pos of each token's k-th choice in token-major order (E*C
    where the choice was dropped), then ``route``'s three results."""
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
    aux = cfg.router_aux_coef * E * (me * ce).sum(-1).mean()

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
            disp_gate[:, :-1].reshape(B, E, C), aux)


def route(cfg, x: torch.Tensor, router: torch.Tensor,
          capacity_factor: float = 1.25):
    """The reference's routing of x (B, S, d) with router (d, E).

    Returns ``disp_tok`` (B, E, C) int64: the token in each expert slot,
    S for an empty one; ``disp_gate`` (B, E, C) float32: its
    renormalised gate, 0 for an empty slot; and ``aux``, the
    Switch-style load-balance loss (per group, then averaged)."""
    return _dispatch(cfg, x, router, capacity_factor)[1:]


def apply_moe(cfg, p, x: torch.Tensor, *, capacity_factor: float = 1.25):
    """x: (B, S, d) -> (out (B, S, d) in x's type, aux scalar)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    slot, disp_tok, disp_gate, aux = _dispatch(cfg, x, p["router"],
                                               capacity_factor)
    C = disp_tok.shape[-1]

    x_pad = torch.cat([x, x.new_zeros((B, 1, d))], dim=1)      # (B, S+1, d)
    rows = torch.arange(B, device=x.device)[:, None]
    expert_in = x_pad[rows, disp_tok.reshape(B, E * C)]         # (B, EC, d)
    # experts leading: (E, B*C, d), one batched product per projection
    xe = expert_in.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    act = _act(cfg.activation)
    h = torch.bmm(xe, p["up"]) * act(torch.bmm(xe, p["gate"]))
    expert_out = torch.bmm(h, p["down"])                        # (E, BC, d)
    expert_out = expert_out.reshape(E, B, C, d).transpose(0, 1)

    # combine: each token gathers its K slots (a dropped choice reads
    # the zero row at E*C) and sums them in k order
    weighted = expert_out.float() * disp_gate[..., None]        # (B,E,C,d)
    weighted = torch.cat([weighted.reshape(B, E * C, d),
                          weighted.new_zeros((B, 1, d))], dim=1)
    picked = weighted[rows, slot].reshape(B, S, K, d)
    out = picked[:, :, 0]
    for k in range(1, K):
        out = out + picked[:, :, k]
    out = out.to(x.dtype)

    if cfg.num_shared_experts:
        sh = (x @ p["shared_up"]) * act(x @ p["shared_gate"])
        out = out + sh @ p["shared_down"]
    return out, aux
