"""Zamba2 [arXiv:2411.15242] in PyTorch: a Mamba2 backbone and one
*weight-shared* attention+MLP block applied before every group of
``shared_attn_every`` Mamba2 layers.

The port of ``repro.models.zamba2``: ``schema``, ``forward``,
``init_cache``, ``prefill`` and the non-in-place ``decode_step``.  The
backbone's leaves stay stacked ``(G, shared_attn_every, ...)``, as the
reference keeps them, and Python loops over group and layer views take
the place of its nested ``lax.scan``.  The shared block is one set of
weights, unstacked; it is the dense transformer's layer
(``transformer.block_seq`` / ``block_decode``, the reference's
``_shared_block_seq`` and the attention half of its decode group body).

Per forward: 2 RMSNorms per Mamba2 layer (its pre-norm and the gated
inner norm), 2 per shared-block application and the final one (127 at
54 layers in 9 groups); at prefill one ``ssd_scan`` per Mamba2 layer
and one flash-attention call per group, at each decode step one
flash-decode call per group.

The cache holds, besides ``pos`` and the shared block's k/v per group
``(G, B, max_len, KV, D)``, each Mamba2 layer's states: ``conv``
``(G, E, B, W-1, C)``, bfloat16 after ``init_cache``/``prefill`` and
the activations' type after a decode step (as the reference's), and
``ssm`` ``(G, E, B, H, P, N)`` float32.  ``RunConfig`` knobs the port
does not implement raise ``NotImplementedError``
(``transformer.check_run``), and so does ``remat`` "block" or "group"
(the reference checkpoints each group there; not ported).  ``forward``
is differentiable: the ``ssd_scan``, ``rmsnorm`` and flash-attention
wrappers carry a gradient on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import kv_cache
from repro_torch.models.layers import (
    apply_norm, attn_schema, embed, embed_schema, mlp_schema, norm_schema,
    rope_tables, unembed)
from repro_torch.models.ssm import (mamba2_forward, mamba2_init_state,
                                    mamba2_schema, mamba2_step)
from repro_torch.models.transformer import (
    block_decode, block_seq, check_run as _check_dense, layer_params,
    stack_schema, stacked_kv, unstack, write_stacked)


def _groups(cfg: ModelConfig) -> int:
    if cfg.num_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} is not a "
                         f"multiple of shared_attn_every="
                         f"{cfg.shared_attn_every}")
    return cfg.num_layers // cfg.shared_attn_every


def schema(cfg: ModelConfig):
    mamba_layer = {"ln": norm_schema(cfg), "mamba": mamba2_schema(cfg)}
    return {
        "embed": embed_schema(cfg),
        "final_norm": norm_schema(cfg),
        "groups": stack_schema(
            stack_schema(mamba_layer, cfg.shared_attn_every), _groups(cfg)),
        "shared": {"ln1": norm_schema(cfg), "attn": attn_schema(cfg),
                   "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg)},
    }


def check_run(cfg: ModelConfig, run: RunConfig) -> None:
    """``transformer.check_run``, and raise for ``remat``, which zamba2
    does not port."""
    _check_dense(cfg, run)
    if run.remat in ("block", "group"):
        raise NotImplementedError(
            f"{cfg.name}: RunConfig.remat={run.remat!r} is not ported for "
            f"zamba2 (only 'none' and 'full', which do nothing)")


def _mamba_params(params, g: int, i: int):
    return layer_params(layer_params(params["groups"], g), i)


def _backbone(cfg: ModelConfig, params, tokens: torch.Tensor,
              run: RunConfig):
    """Embed, then per group the shared block and its Mamba2 layers.
    Returns x (B, S, d), the shared block's (k, v) per group and each
    Mamba2 layer's final states, in layer order."""
    S = tokens.shape[1]
    x = embed(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.float32,
                             device=tokens.device)[None]
    tab = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    window = run.decode_window or 0
    kvs, states = [], []
    for group in unstack(params["groups"]):
        x, _, kv = block_seq(cfg, params["shared"], x, positions, tab,
                             run, window=window)
        kvs.append(kv)
        for lp in unstack(group):
            h, st = mamba2_forward(cfg, lp["mamba"],
                                   apply_norm(cfg, lp["ln"], x))
            x = x + h
            states.append(st)
    return x, kvs, states


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, run: RunConfig,
            extras: Optional[dict] = None, collect_kv: bool = False,
            last_only: bool = False):
    """tokens: (B, S) -> (logits, aux, kvs or None).  aux is 0.0; kvs
    (when collect_kv) are the shared block's k and v per group, each
    (G, B, S, KV, D)."""
    check_run(cfg, run)
    x, kvs, _ = _backbone(cfg, params, tokens, run)
    if last_only:
        x = x[:, -1:].contiguous()
    logits = unembed(cfg, params["embed"],
                     apply_norm(cfg, params["final_norm"], x))
    if not collect_kv:
        return logits, 0.0, None
    return logits, 0.0, (torch.stack([k for k, _ in kvs]),
                         torch.stack([v for _, v in kvs]))


def _stack_states(cfg: ModelConfig, states):
    """Per-layer state dicts, in layer order -> {"conv", "ssm"}, each
    (G, E, ...)."""
    lead = (_groups(cfg), cfg.shared_attn_every)
    return {key: torch.stack([st[key] for st in states]).reshape(
        lead + states[0][key].shape) for key in ("conv", "ssm")}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, run: RunConfig,
               device="cuda"):
    """A cache of zeros (see the module docstring); ``device="meta"``
    gives shapes only."""
    check_run(cfg, run)
    G, E = _groups(cfg), cfg.shared_attn_every
    one = mamba2_init_state(cfg, batch, torch.bfloat16, device)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": stacked_kv(cfg, G, batch, max_len, run, device),
            "v": stacked_kv(cfg, G, batch, max_len, run, device),
            "ssm": {k: v.expand((G, E) + v.shape).clone()
                    for k, v in one.items()}}


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_len: int,
            run: RunConfig, extras: Optional[dict] = None):
    """Run the full prompt and build a max_len cache holding the shared
    block's k/v and every Mamba2 layer's final states, cast to the
    cache's types (the conv state to bfloat16).  Returns (logits,
    cache)."""
    check_run(cfg, run)
    B, S = tokens.shape
    x, kvs, states = _backbone(cfg, params, tokens, run)
    if run.prefill_logits == "last":
        x = x[:, -1:].contiguous()
    logits = unembed(cfg, params["embed"],
                     apply_norm(cfg, params["final_norm"], x))
    cache = init_cache(cfg, B, max_len, run, tokens.device)
    pos0 = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    write_stacked(cache["k"], torch.stack([k for k, _ in kvs]), pos0)
    write_stacked(cache["v"], torch.stack([v for _, v in kvs]), pos0)
    for key, val in _stack_states(cfg, states).items():
        cache["ssm"][key].copy_(val)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    return logits, cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                run: RunConfig, extras: Optional[dict] = None):
    """token: (B, 1) -> (logits (B, 1, V), updated cache): the
    reference's non-in-place branch.  The updated cache is new; the one
    passed in is left as it was."""
    check_run(cfg, run)
    pos = cache["pos"]
    x = embed(params["embed"], token)
    kc_all, vc_all = kv_cache.clone(cache["k"]), kv_cache.clone(cache["v"])
    # shared by every group: rotary tables and cache write slots
    tab = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    S = (kc_all["q"] if isinstance(kc_all, dict) else kc_all).shape[2]
    index = kv_cache.write_index(pos, 1, S)
    states = []
    for g in range(_groups(cfg)):
        x, _ = block_decode(cfg, params["shared"], x, pos,
                            layer_params(kc_all, g),
                            layer_params(vc_all, g), run, tab, index)
        for i in range(cfg.shared_attn_every):
            lp = _mamba_params(params, g, i)
            st = {key: val[g, i] for key, val in cache["ssm"].items()}
            h, st = mamba2_step(cfg, lp["mamba"],
                                apply_norm(cfg, lp["ln"], x), st)
            x = x + h
            states.append(st)
    logits = unembed(cfg, params["embed"],
                     apply_norm(cfg, params["final_norm"], x))
    return logits, dict(cache, k=kc_all, v=vc_all,
                        ssm=_stack_states(cfg, states), pos=pos + 1)
