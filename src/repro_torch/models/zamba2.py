"""Zamba2 [arXiv:2411.15242] in PyTorch: a Mamba2 backbone and one
*weight-shared* attention+MLP block applied before every group of
``shared_attn_every`` Mamba2 layers.

The port of ``repro.models.zamba2``: ``schema``, ``forward``,
``init_cache``, ``prefill`` and ``decode_step`` (both of the
reference's branches: the default one, and ``decode_inplace_cache``,
whose shared block attends over the cache as it was before the write
with the new token out of band, in plain torch).  The
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
flash-decode call per group (none under ``decode_inplace_cache``).

The cache holds, besides ``pos`` and the shared block's k/v per group
``(G, B, max_len, KV, D)``, each Mamba2 layer's states: ``conv``
``(G, E, B, W-1, C)``, bfloat16 after ``init_cache``/``prefill`` and
the activations' type after a decode step (as the reference's), and
``ssm`` ``(G, E, B, H, P, N)`` float32.  As in the reference, only
the in-place branch honours ``decode_slice_reads``.  ``RunConfig`` knobs
the port does not implement raise ``NotImplementedError``
(``transformer.check_run``).  ``forward`` is differentiable: the
``ssd_scan``, ``rmsnorm`` and flash-attention wrappers carry a gradient
on the card.  ``remat`` "block" and "group" recompute each group, the
shared block and its Mamba2 layers, in the backward (a
``torch.utils.checkpoint`` where the reference ``jax.checkpoint``s its
group body): a step then launches each group's kernels twice, all but
the final norm; "full" does nothing, as in the reference.

Under a device mesh (DTensor params placed by
``launch.shardings.model_param_pspecs``, the rules installed) tokens
are split on ``data``, the residual stream constrained after each
Mamba2 layer and the shared block as the reference's, the cache placed
by ``shardings.cache_pspecs`` (the SSM state on ``ssm_inner``'s heads,
the conv state whole over ``model``), and ``ssd_scan`` reached through
``local_map`` (``models.ssm``), under ``remat`` too.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import kv_cache
from repro_torch.models.layers import (
    apply_norm, attn_schema, embed, embed_schema, mlp_schema, norm_schema,
    rope_tables, unembed)
from repro_torch.models.params import constrain, is_dtensor, shard_batch
from repro_torch.models.ssm import (mamba2_forward, mamba2_init_state,
                                    mamba2_schema, mamba2_step)
from repro_torch.models.transformer import (
    block_decode, block_seq, check_run, layer_params, place_cache, segment,
    stack_schema, stacked_kv, step_buffers, unstack, write_prefill)


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


def _mamba_params(params, g: int, i: int):
    return layer_params(layer_params(params["groups"], g), i)


def _group_seq(cfg: ModelConfig, shared, group, x, positions, tab,
               run: RunConfig):
    """One group: the shared block, then the group's Mamba2 layers.
    Returns (x, the shared block's (k, v), each Mamba2 layer's final
    states)."""
    x, _, kv = block_seq(cfg, shared, x, positions, tab, run,
                         window=run.decode_window or 0)
    states = []
    for lp in unstack(group):
        h, st = mamba2_forward(cfg, lp["mamba"], apply_norm(cfg, lp["ln"], x))
        x = constrain(x + h, ("batch", "seq", "embed"))
        states.append(st)
    return x, kv, states


def _backbone(cfg: ModelConfig, params, tokens: torch.Tensor,
              run: RunConfig):
    """Embed, then per group the shared block and its Mamba2 layers,
    each group recomputed in the backward under ``remat`` "block" or
    "group".  Returns x (B, S, d), the shared block's (k, v) per group
    and each Mamba2 layer's final states, in layer order."""
    S = tokens.shape[1]
    tokens = shard_batch(params, tokens)
    x = constrain(embed(params["embed"], tokens), ("batch", "seq", "embed"))
    positions = torch.arange(S, dtype=torch.float32,
                             device=tokens.device)[None]
    tab = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    kvs, states = [], []
    for group in unstack(params["groups"]):
        x, kv, st = segment(run.remat in ("block", "group"), _group_seq,
                            cfg, params["shared"], group, x, positions, tab,
                            run)
        kvs.append(kv)
        states.extend(st)
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
               device="cuda", mesh=None):
    """A cache of zeros (see the module docstring); ``device="meta"``
    gives shapes only.  With a device ``mesh`` (and rules installed),
    DTensors placed by ``shardings.cache_pspecs``: the SSM states split
    on ``ssm_inner``'s heads, the conv states whole on ``model``."""
    check_run(cfg, run)
    if mesh is not None:
        return place_cache(cfg, run, init_cache(cfg, batch, max_len, run,
                                                device), mesh)
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
    cache = write_prefill(cfg, run, params,
                          {"k": torch.stack([k for k, _ in kvs]),
                           "v": torch.stack([v for _, v in kvs])},
                          B, S, max_len, tokens.device, init=init_cache)
    for key, val in _stack_states(cfg, states).items():
        cache["ssm"][key].copy_(val)
    return logits, cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                run: RunConfig, extras: Optional[dict] = None):
    """token: (B, 1) -> (logits (B, 1, V), updated cache).  The updated
    cache is new and the one passed in is left as it was, but under
    ``decode_inplace_cache``, where its k and v buffers are written in
    place and returned."""
    check_run(cfg, run)
    pos = cache["pos"]
    token = shard_batch(params, token)
    x = constrain(embed(params["embed"], token), ("batch", None, "embed"))
    kc_all, vc_all = step_buffers(cache, run)
    # shared by every group: rotary tables and cache write slots
    tab = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    S = (kc_all["q"] if isinstance(kc_all, dict) else kc_all).shape[2]
    index = None if is_dtensor(pos) else kv_cache.write_index(pos, 1, S)
    states = []
    for g in range(_groups(cfg)):
        x, _ = block_decode(cfg, params["shared"], x, pos,
                            layer_params(kc_all, g),
                            layer_params(vc_all, g), run, tab, index,
                            slice_reads=False)
        for i in range(cfg.shared_attn_every):
            lp = _mamba_params(params, g, i)
            st = {key: val[g, i] for key, val in cache["ssm"].items()}
            h, st = mamba2_step(cfg, lp["mamba"],
                                apply_norm(cfg, lp["ln"], x), st)
            x = constrain(x + h, ("batch", None, "embed"))
            states.append(st)
    logits = unembed(cfg, params["embed"],
                     apply_norm(cfg, params["final_norm"], x))
    return logits, dict(cache, k=kc_all, v=vc_all,
                        ssm=_stack_states(cfg, states), pos=pos + 1)
