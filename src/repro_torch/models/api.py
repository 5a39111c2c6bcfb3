"""Model API: model lookup, step factories and initialisation.

The port of ``repro.models.api`` for all six of the reference's
families: the transformer (dense, MoE and the cross-attention VLM), the
hybrid Mamba2 + shared-attention model (zamba2), whisper (audio) and
xLSTM (ssm).  Each model module exposes ``schema``, ``forward``,
``prefill``, ``decode_step`` and ``init_cache``.  ``make_train_step``
builds the training loss (the reference's name for it: it returns the
loss function, not a step).  ``input_specs`` and ``abstract_model``
give a step's inputs and params on the meta device, for the dry run
(``repro_torch.launch.dryrun``); ``model_pspecs`` the params' partition
specs under sharding rules (``repro_torch.launch.shardings``).
"""

from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import transformer, whisper, xlstm_model, zamba2
from repro_torch.models.params import (constrain, init_params, is_dtensor,
                                       local_call, map_schema, param_pspecs,
                                       shard_batch)


def get_model(cfg: ModelConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return transformer
    if cfg.family == "audio":
        return whisper
    if cfg.family == "hybrid":
        return zamba2
    if cfg.family == "ssm":
        return xlstm_model
    raise ValueError(f"unknown family {cfg.family!r}")


def extra_input_specs(cfg: ModelConfig, batch: int, abstract: bool = True,
                      dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The modality front ends' stub inputs, as the reference gives
    them: zeros ``audio_frames`` (B, num_audio_frames, d_model) for the
    audio family, ``0.02 * ones`` ``vision_embeds`` (B,
    num_vision_tokens, d_model) for the VLM, on ``device`` (the meta
    device when ``abstract``); None for the families that take none."""
    get_model(cfg)
    device = "meta" if abstract else device
    extras = {}
    if cfg.family == "audio":
        extras["audio_frames"] = torch.zeros(
            (batch, cfg.num_audio_frames, cfg.d_model), dtype=dtype,
            device=device)
    if cfg.family == "vlm":
        extras["vision_embeds"] = torch.full(
            (batch, cfg.num_vision_tokens, cfg.d_model), 0.02, dtype=dtype,
            device=device)
    return extras or None


def input_specs(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                abstract: bool = True, device="cuda"):
    """Every model input of one step at ``shape``, as the reference's:
    train {tokens, labels}, prefill {tokens}, decode {token (B, 1),
    cache (seq_len rows, from ``init_cache``)}, each with the family's
    ``extras``.  Tokens are int32.  On the meta device (shapes and
    types, no storage) when ``abstract``, else zeros on ``device``."""
    B, S = shape.global_batch, shape.seq_len
    device = "meta" if abstract else device

    def tokens(shp):
        return torch.zeros(shp, dtype=torch.int32, device=device)

    specs = {}
    if shape.kind == "train":
        specs["tokens"] = tokens((B, S))
        specs["labels"] = tokens((B, S))
    elif shape.kind == "prefill":
        specs["tokens"] = tokens((B, S))
    else:              # decode: ONE new token against a seq_len cache
        specs["token"] = tokens((B, 1))
        specs["cache"] = get_model(cfg).init_cache(cfg, B, S, run,
                                                   device=device)
    extras = extra_input_specs(cfg, B, abstract=abstract, device=device)
    if extras:
        specs["extras"] = extras
    return specs


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """``loss_fn(params, tokens, labels, extras=None) -> (loss, nll)``:
    the mean next-token negative log-likelihood of ``forward``'s logits
    (in float32) plus the model's aux loss (MoE), as the reference's,
    for every family; ``extras`` are the modality inputs ``forward``
    reads (whisper's ``audio_frames``, the VLM's ``vision_embeds``).

    On sharded params the labels are sharded on ``batch`` as the tokens,
    the logits gathered over the vocab, each rank's rows scored on its
    own, and the loss and nll returned as plain (replicated) tensors."""
    mod = get_model(cfg)

    def nll_rows(logits, labels):
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return logz - gold

    def loss_fn(params, tokens, labels, extras=None):
        logits, aux, _ = mod.forward(cfg, params, tokens, run, extras)
        if not is_dtensor(logits):
            nll = nll_rows(logits, labels).mean()
            return nll + aux, nll
        logits = constrain(logits, ("batch", "seq", None))
        labels = constrain(shard_batch(params, labels), ("batch", "seq"))
        nll = local_call(nll_rows, tuple(labels.placements), logits,
                         labels).mean()
        loss = nll + aux
        return loss.full_tensor(), nll.full_tensor()

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


def abstract_model(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
    """Params of ``cfg`` on the meta device: every leaf's shape in
    ``dtype`` (bfloat16 by default, as the reference's) and no
    storage."""
    return map_schema(
        lambda p, _path: torch.empty(p.shape, dtype=dtype, device="meta"),
        get_model(cfg).schema(cfg))


def model_pspecs(cfg: ModelConfig, rules: dict):
    """The ``PS`` of every param leaf of ``cfg`` under ``rules``."""
    return param_pspecs(get_model(cfg).schema(cfg), rules)
