"""AdamW and LR schedules on tensors.

The port of ``repro.training.optimizer``, with its arithmetic: clip by
the global norm (``+1e-9``), bias-corrected moments, ``delta = mh /
(sqrt(vh) + eps) + wd * p`` with weight decay on every leaf.  Plain
tensor ops, not ``torch.optim.AdamW`` or ``clip_grad_norm_``, whose
epsilons sit elsewhere.  ``step``, the learning rate and the clip scale
stay tensors on the params' device, so a step makes no host sync.

``apply_updates`` updates params and moments in place (the reference
returns new trees): at full width a second copy of each would cost as
much memory as the model.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"      # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor, kept on its
    device) as a float32 tensor: linear warmup, then the schedule's
    decay to 0 at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def leaves(tree):
    """The tensors of a nested dict / list tree, in the order of its
    keys as given (a param tree and its grads or moments walk alike)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init_state(params):
    """{"step": int32 0, "m": zeros, "v": zeros}, float32 moments on
    each leaf's device (placed as each leaf where params are
    DTensors)."""
    device = leaves(params)[0].device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state):
    """One AdamW step, in place on ``params`` and ``state``'s moments.
    Returns (params, new_state, {"grad_norm", "lr"}), the metrics as
    device tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(b1, stepf)
    bc2 = 1.0 - torch.pow(b2, stepf)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"]), strict=True):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    if hasattr(gnorm, "full_tensor"):     # DTensor grads: a plain metric
        gnorm = gnorm.full_tensor()
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
