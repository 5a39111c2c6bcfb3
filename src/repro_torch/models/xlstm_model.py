"""xLSTM-125M in PyTorch: alternating mLSTM and sLSTM blocks.

The port of ``repro.models.xlstm_model``: ``schema``, ``forward``,
``init_cache``, ``prefill`` and ``decode_step``, with tied embeddings.
With ``xlstm_slstm_every = 2`` the 12 layers form 6 groups of (mLSTM
block, sLSTM block); the group leaves stay stacked ``(G, ...)`` and a
Python loop over group views takes the place of the reference's
``lax.scan``.  Attention-free: the decode "cache" is the recurrent
state, O(1) in the sequence length:

  * ``mlstm``: ``conv`` (G, B, 3, d_in) in the activations' type and
    ``mem`` (G, B, H, Dh + 1, Dh) float32;
  * ``slstm``: ``cell``, a tuple (c, n, h, m), each (G, B, d) float32.

Per forward or decode step: one RMSNorm launch per block (the blocks'
inner norms; the pre-norms and the final norm are xlstm-125m's
layernorms), no attention.  ``forward`` is differentiable (the per-head
``ssd_chunked`` and the sLSTM time loop are plain torch); ``remat``
"block" and "group" recompute each group in the backward (a
``torch.utils.checkpoint`` where the reference ``jax.checkpoint``s its
group body), and "full" does nothing.

Under a device mesh the residual stream is constrained after each block
as the reference's, and the cache placed by ``shardings.cache_pspecs``:
the mLSTM conv state split on ``ssm_inner``, its memory and the sLSTM
cells whole over ``model`` (``models.xlstm``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models.layers import (apply_norm, embed, embed_schema,
                                       norm_schema, unembed)
from repro_torch.models.params import constrain, mesh_of, shard_batch
from repro_torch.models.transformer import (
    check_run, layer_params, place_cache, segment, stack_schema, unstack)
from repro_torch.models.xlstm import (
    mlstm_forward, mlstm_init_state, mlstm_schema, mlstm_step,
    slstm_forward, slstm_init_state, slstm_schema, slstm_step)


def _groups(cfg: ModelConfig) -> int:
    every = cfg.xlstm_slstm_every or 2
    if cfg.num_layers % every:
        raise ValueError(f"{cfg.name}: num_layers={cfg.num_layers} is not a "
                         f"multiple of xlstm_slstm_every={every}")
    return cfg.num_layers // every


def schema(cfg: ModelConfig):
    group = {"m_ln": norm_schema(cfg), "mlstm": mlstm_schema(cfg),
             "s_ln": norm_schema(cfg), "slstm": slstm_schema(cfg)}
    return {"embed": embed_schema(cfg), "final_norm": norm_schema(cfg),
            "groups": stack_schema(group, _groups(cfg))}


def _stack(states):
    """Per-group state trees (dicts and tuples of tensors), in order ->
    one tree with each leaf stacked (G, ...)."""
    first = states[0]
    if isinstance(first, dict):
        return {k: _stack([s[k] for s in states]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([s[i] for s in states])
                     for i in range(len(first)))
    return torch.stack(states)


def _index(tree, g: int):
    if isinstance(tree, tuple):
        return tuple(t[g] for t in tree)
    return layer_params(tree, g)


def _group_seq(cfg: ModelConfig, gp, x):
    """One group over the sequence: the mLSTM block, then the sLSTM
    block.  Returns (x, mLSTM state, sLSTM state)."""
    h, m = mlstm_forward(cfg, gp["mlstm"], apply_norm(cfg, gp["m_ln"], x))
    x = constrain(x + h, ("batch", "seq", "embed"))
    h, s = slstm_forward(cfg, gp["slstm"], apply_norm(cfg, gp["s_ln"], x))
    return constrain(x + h, ("batch", "seq", "embed")), m, s


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, run: RunConfig,
            extras: Optional[dict] = None, collect_kv: bool = False,
            last_only: bool = False):
    """tokens: (B, S) -> (logits, 0.0, states or None); states (when
    collect_kv) are (mlstm, slstm) stacked over groups, the prefill
    cache's."""
    check_run(cfg, run)
    tokens = shard_batch(params, tokens)
    x = constrain(embed(params["embed"], tokens), ("batch", "seq", "embed"))
    mst, sst = [], []
    for gp in unstack(params["groups"]):
        x, m, s = segment(run.remat in ("block", "group"), _group_seq, cfg,
                          gp, x)
        mst.append(m)
        sst.append(s)
    if last_only:
        x = x[:, -1:].contiguous()
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, 0.0, ((_stack(mst), _stack(sst)) if collect_kv else None)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, run: RunConfig,
               device="cuda", mesh=None):
    """Zero states (see the module docstring); ``max_len`` is unused, the
    state is O(1) in it.  ``device="meta"`` gives shapes only.  With a
    device ``mesh`` (and rules installed), DTensors placed by
    ``shardings.cache_pspecs``."""
    check_run(cfg, run)
    if mesh is not None:
        return place_cache(cfg, run, init_cache(cfg, batch, max_len, run,
                                                device), mesh)
    G = _groups(cfg)
    one = {"mlstm": mlstm_init_state(cfg, batch, device=device),
           "slstm": slstm_init_state(cfg, batch, device=device)}
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            **_stack([one] * G)}


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_len: int,
            run: RunConfig, extras: Optional[dict] = None):
    """Run the prompt; the cache is every block's final state.  Returns
    (logits, cache)."""
    B, S = tokens.shape
    logits, _, (mst, sst) = forward(
        cfg, params, tokens, run, extras, collect_kv=True,
        last_only=run.prefill_logits == "last")
    cache = {"pos": torch.full((B,), S, dtype=torch.int32,
                               device=tokens.device),
             "mlstm": mst, "slstm": sst}
    mesh = mesh_of(params)
    return logits, (cache if mesh is None
                    else place_cache(cfg, run, cache, mesh))


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                run: RunConfig, extras: Optional[dict] = None):
    """token: (B, 1) -> (logits (B, 1, V), updated cache): a new cache of
    new states; the one passed in is left as it was."""
    check_run(cfg, run)
    token = shard_batch(params, token)
    x = constrain(embed(params["embed"], token), ("batch", None, "embed"))
    mst, sst = [], []
    for g in range(_groups(cfg)):
        gp = layer_params(params["groups"], g)
        h, m = mlstm_step(cfg, gp["mlstm"], apply_norm(cfg, gp["m_ln"], x),
                          _index(cache["mlstm"], g))
        x = x + h
        h, s = slstm_step(cfg, gp["slstm"], apply_norm(cfg, gp["s_ln"], x),
                          {"cell": _index(cache["slstm"]["cell"], g)})
        x = x + h
        mst.append(m)
        sst.append(s)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, dict(cache, mlstm=_stack(mst), slstm=_stack(sst),
                        pos=cache["pos"] + 1)
