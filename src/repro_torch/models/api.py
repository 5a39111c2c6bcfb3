"""Model API: model lookup, step factories and initialisation.

The port of ``repro.models.api`` for the families the port runs: the
transformer (dense and MoE) and the hybrid Mamba2 + shared-attention
model (zamba2).  Each model module exposes ``schema``, ``forward``,
``prefill``, ``decode_step`` and ``init_cache``.  ``make_train_step``
builds the training loss (the reference's name for it: it returns the
loss function, not a step).
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import transformer, zamba2
from repro_torch.models.params import init_params


def get_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe"):
        return transformer
    if cfg.family == "hybrid":
        return zamba2
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                              f"ported (the port runs 'dense', 'moe' and "
                              f"'hybrid')")


def extra_input_specs(cfg: ModelConfig, batch: int, abstract: bool = True,
                      dtype: torch.dtype = torch.bfloat16):
    """The modality-frontend inputs of ``cfg`` (the reference's audio
    frames and vision embeddings): None for the families the port runs,
    which take none.  The other families raise, as ``get_model``."""
    get_model(cfg)
    return None


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """``loss_fn(params, tokens, labels, extras=None) -> (loss, nll)``:
    the mean next-token negative log-likelihood of ``forward``'s logits
    (in float32) plus the model's aux loss, as the reference's."""
    mod = get_model(cfg)

    def loss_fn(params, tokens, labels, extras=None):
        logits, aux, _ = mod.forward(cfg, params, tokens, run, extras)
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = (logz - gold).mean()
        return nll + aux, nll

    return loss_fn


def make_prefill_step(cfg: ModelConfig, run: RunConfig, max_len: int):
    mod = get_model(cfg)

    def step(params, tokens, extras=None):
        return mod.prefill(cfg, params, tokens, max_len, run, extras)

    return step


def make_decode_step(cfg: ModelConfig, run: RunConfig):
    mod = get_model(cfg)

    def step(params, token, cache, extras=None):
        return mod.decode_step(cfg, params, token, cache, run, extras)

    return step


def init_model(cfg: ModelConfig, generator: torch.Generator, device,
               dtype: torch.dtype = torch.float32):
    """Random params of ``cfg`` on ``device``, drawn from ``generator``
    (on the generator's device).  Float32 by default, as the
    reference's ``init_model``."""
    return init_params(get_model(cfg).schema(cfg), generator, device, dtype)
