"""Training step and loop: loss -> grads -> AdamW.

The port of ``repro.training.train``.  Params are leaf tensors that
need a gradient (``train_step`` marks them); the backward fills their
``.grad``, which stays until the next step clears it, and AdamW updates
them in place.  A leaf the backward did not reach raises, as JAX would
fail to build its gradient tree; ``train_loop`` returns the params
released (no ``.grad``, no need of one), ready to serve.  Every family
trains, the modality inputs (``extras``: whisper's ``audio_frames``, the
VLM's ``vision_embeds``) passed to the loss on the params' device.  On
the card the forward launches these kernels through
``kernels.KernelFunction``, whose backward is the plain version's
autograd (under ``remat`` the recompute launches them again):

  * dense, MoE and the VLM: rmsnorm (where the config's norm is RMSNorm)
    and flash_attention (self, and the VLM's cross attention);
  * zamba2: rmsnorm, flash_attention (the shared block) and ssd_scan;
  * whisper: flash_attention (encoder, causal self, cross), no rmsnorm;
  * xLSTM: rmsnorm (each block's inner norm); its per-head scan and the
    sLSTM loop are plain torch.

An explicit ``torch.Generator`` takes the place of the reference's PRNG
key.

Params may be DTensors over a device mesh (every family,
``launch.shardings.distribute`` under ``params.use_rules``): the
extras are sharded on ``data`` as the tokens, the loss comes back
replicated, each leaf's gradient is placed as the leaf, and AdamW and
the global-norm clip run as DTensor ops.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import api
from repro_torch.models.params import shard_batch
from repro_torch.training import optimizer as opt


def make_loss_fn(cfg: ModelConfig, run: RunConfig):
    """``loss_fn(params, tokens, labels, extras=None) -> (loss, nll)``
    (``models.api.make_train_step``)."""
    return api.make_train_step(cfg, run)


def trainable(params):
    """Mark every leaf of ``params`` as needing a gradient; raises for a
    tensor that is not a leaf of autograd's graph."""
    for p in opt.leaves(params):
        if p.grad_fn is not None:
            raise ValueError("train: every param must be a leaf tensor")
        p.requires_grad_(True)
    return params


def release(params):
    """Drop every leaf's ``.grad`` and its need of a gradient, so trained
    params serve as plain tensors (the serving path launches the kernels
    directly, and decode_attention raises under grad)."""
    for p in opt.leaves(params):
        p.grad = None
        p.requires_grad_(False)
    return params


def _grads(params, prefix=""):
    """The tree of the leaves' ``.grad``, a DTensor leaf's placed as the
    leaf (a Partial sum reduced); raises naming a leaf that got none (a
    detached output on its path)."""
    if isinstance(params, dict):
        return {k: _grads(v, f"{prefix}{k}/") for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_grads(v, f"{prefix}{i}/") for i, v in enumerate(params)]
    if params.grad is None:
        raise ValueError(f"train: no gradient reached param "
                         f"{prefix.rstrip('/')}")
    g = params.grad
    if hasattr(g, "placements") and g.placements != params.placements:
        g = params.grad = g.redistribute(params.device_mesh,
                                         params.placements)
    return g


def extras_on(extras, device, params=None):
    """The modality inputs ``extras`` (None, or a dict of tensors or
    arrays) as tensors on ``device``; sharded on ``batch`` when
    ``params`` are DTensors (the reference's ``input_pspecs``:
    ``batch_spec(rules, None, None)``)."""
    if extras is None:
        return None
    return {k: shard_batch(params, torch.as_tensor(v, device=device))
            for k, v in extras.items()}


def make_train_step(cfg: ModelConfig, run: RunConfig,
                    ocfg: Optional[opt.AdamWConfig] = None):
    """``train_step(params, opt_state, tokens, labels, extras=None) ->
    (params, opt_state, metrics)``; metrics {"grad_norm", "lr", "loss",
    "nll"} are device tensors.  ``extras`` go to the params' device."""
    ocfg = ocfg or opt.AdamWConfig()
    loss_fn = make_loss_fn(cfg, run)

    def train_step(params, opt_state, tokens, labels, extras=None):
        leaves = opt.leaves(trainable(params))
        for p in leaves:
            p.grad = None
        loss, nll = loss_fn(params, tokens, labels,
                            extras_on(extras, leaves[0].device, params))
        loss.backward()
        grads = _grads(params)
        params, opt_state, metrics = opt.apply_updates(
            ocfg, params, grads, opt_state)
        metrics = dict(metrics, loss=loss.detach(), nll=nll.detach())
        return params, opt_state, metrics

    return train_step


def train_loop(cfg: ModelConfig, run: RunConfig, data_iter, *,
               steps: int, ocfg: Optional[opt.AdamWConfig] = None,
               params=None, generator: Optional[torch.Generator] = None,
               device="cuda", log_every: int = 10, extras=None,
               callback=None):
    """Single-device training loop.  ``data_iter`` yields numpy
    (tokens, labels); ``extras`` (the modality inputs of whisper and the
    VLM) go with every step, on ``device``.  ``params`` None draws them
    with ``generator``
    (default: seed 0 on ``device``).  Every ``log_every`` steps and at
    the last, an entry of the metrics as floats (a host sync) goes to
    the history and to ``callback``, where the step's ``.grad`` can
    still be read.  Returns (params, opt_state, history), the params
    released.  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if params is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = api.init_model(cfg, generator, dev)
    opt_state = opt.init_state(params)
    step_fn = make_train_step(cfg, run, ocfg)
    extras = extras_on(extras, dev)
    history = []
    for i in range(steps):
        tokens, labels = next(data_iter)
        params, opt_state, m = step_fn(
            params, opt_state, torch.as_tensor(tokens, device=dev),
            torch.as_tensor(labels, device=dev), extras)
        if i % log_every == 0 or i == steps - 1:
            entry = {k: float(v) for k, v in m.items()}
            entry["step"] = i
            history.append(entry)
            if callback:
                callback(entry)
    return release(params), opt_state, history
