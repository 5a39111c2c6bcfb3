"""Model API: model lookup, step factories and initialisation.

The port of ``repro.models.api`` for the families the port runs: the
dense transformer and the hybrid Mamba2 + shared-attention model
(zamba2).  Each model module exposes ``schema``, ``forward``,
``prefill``, ``decode_step`` and ``init_cache``.
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import transformer, zamba2
from repro_torch.models.params import init_params


def get_model(cfg: ModelConfig):
    if cfg.family == "dense":
        return transformer
    if cfg.family == "hybrid":
        return zamba2
    raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not "
                              f"ported (the port runs 'dense' and "
                              f"'hybrid')")


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
