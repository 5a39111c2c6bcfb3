"""Decoder-only transformer LM, dense family, in PyTorch.

The port of ``repro.models.transformer`` for the dense family
(``tinyllama-1.1b``): ``schema``, ``forward``, ``init_cache``,
``prefill`` and ``decode_step``.  Layer weights stay *stacked* (each
leaf ``(L, ...)``, as the reference keeps them), and a Python loop over
layer views takes the place of the reference's ``lax.scan``.

Per forward: 2 RMSNorms per layer plus the final one (45 at 22 layers),
one flash-attention call per layer at prefill and one flash-decode call
per layer at each decode step.

The default decode path is the reference's non-in-place one: each step
returns a new cache and leaves the caller's as it was.  ``forward`` is
differentiable (the training path): ``RunConfig.remat="block"``
recomputes each layer in the backward (``torch.utils.checkpoint``, as
the reference's ``jax.checkpoint`` of its scan body), and ``"full"`` and
``"group"`` do what they do in the reference's dense transformer without
cross-attention: nothing.  ``RunConfig`` knobs this port does not
implement raise ``NotImplementedError`` (``check_run``); MoE and
cross-attention configs raise too.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import kv_cache
from repro_torch.models.layers import (
    apply_mlp, apply_norm, attn_schema, chunked_attention, decode_attention,
    embed, embed_schema, mlp_schema, norm_schema, out_project, qkv_project,
    rope_tables, unembed)
from repro_torch.models.params import P, map_schema

# RunConfig fields the port does not implement, with the value that
# means "off" (the reference's default)
_UNPORTED_KNOBS = {"decode_inplace_cache": False, "decode_slice_reads": False,
                   "decode_uniform_pos": False, "prefill_parallel_q": False,
                   "fsdp": False, "shard_kv_seq": False}


def check_run(cfg: ModelConfig, run: RunConfig) -> None:
    """Raise for what this port of the transformer does not implement."""
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE blocks are not ported")
    if cfg.cross_attn_every:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers are not ported")
    for name, off in _UNPORTED_KNOBS.items():
        if getattr(run, name) != off:
            raise NotImplementedError(
                f"RunConfig.{name}={getattr(run, name)!r} is not ported "
                f"(only {off!r})")
    if run.prefill_logits not in ("all", "last"):
        raise ValueError(f"prefill_logits={run.prefill_logits!r}")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def stack_schema(sub, n: int):
    """Every leaf of ``sub`` with a leading layer axis of size n."""
    return map_schema(lambda p, _path: P((n,) + p.shape, init=p.init,
                                         scale=p.scale), sub)


def _layer_schema(cfg: ModelConfig):
    return {"ln1": norm_schema(cfg), "attn": attn_schema(cfg),
            "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg)}


def schema(cfg: ModelConfig):
    return {"embed": embed_schema(cfg), "final_norm": norm_schema(cfg),
            "layers": stack_schema(_layer_schema(cfg), cfg.num_layers)}


def layer_params(stacked, i: int):
    """Layer ``i``'s params: a view of each stacked leaf."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def unstack(stacked):
    """Every layer's params, in order: views of each stacked leaf from
    one ``unbind`` per leaf.  Its backward stacks the layers' gradients
    once, where one ``layer_params`` select a layer would add a
    zero-padded gradient of the whole stacked leaf per layer."""
    if isinstance(stacked, dict):
        parts = {k: unstack(v) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return stacked.unbind(0)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def block_seq(cfg, lp, x, positions, rope_tab, window: int = 0,
              causal: bool = True):
    """One layer over a full sequence; returns (x, (k, v))."""
    q, k, v = qkv_project(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x),
                          positions=positions, rope_tab=rope_tab)
    o = chunked_attention(q, k, v, causal=causal, window=window)
    x = x + out_project(lp["attn"], o)
    h = apply_norm(cfg, lp["ln2"], x)
    return x + apply_mlp(cfg, lp["mlp"], h), (k, v)


def block_decode(cfg, lp, x, pos, kc, vc, run: RunConfig, rope_tab, index):
    """Single-token decode for one layer.  x: (B,1,d); pos: (B,) write
    index; kc/vc: this layer's cache buffers, written in place at
    ``index`` (``kv_cache.write_index``); rope_tab: the rotary tables
    of ``pos``."""
    h = apply_norm(cfg, lp["ln1"], x)
    q, k, v = qkv_project(cfg, lp["attn"], h, positions=pos[:, None],
                          rope_tab=rope_tab)
    kv_cache.write_(kc, k, pos, index)
    kv_cache.write_(vc, v, pos, index)
    o = _decode_attend(q, kc, vc, pos, run)
    x = x + out_project(lp["attn"], o)
    h = apply_norm(cfg, lp["ln2"], x)
    return x + apply_mlp(cfg, lp["mlp"], h)


def _decode_attend(q, kc, vc, pos, run: RunConfig):
    """Attention over one layer's cache (the reference's default branch;
    ``decode_slice_reads`` is not ported)."""
    return decode_attention(q, kv_cache.read(kc), kv_cache.read(vc), pos + 1,
                            window=run.decode_window)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, tokens: torch.Tensor, run: RunConfig,
            extras: Optional[dict] = None, collect_kv: bool = False,
            last_only: bool = False):
    """tokens: (B, S) -> (logits, aux, kvs or None).  aux is 0.0 (no MoE
    load-balance loss in the dense family); kvs (when collect_kv) are
    stacked per-layer (L, B, S, KV, D) pairs, the prefill cache."""
    check_run(cfg, run)
    S = tokens.shape[1]
    x = embed(params["embed"], tokens)
    positions = torch.arange(S, dtype=torch.float32,
                             device=tokens.device)[None]
    window = run.decode_window or 0
    tab = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    ks, vs = [], []
    for lp in unstack(params["layers"]):
        if run.remat == "block":
            # recomputed in the backward; the blocks draw no random
            # numbers, so no RNG state is kept
            x, (k, v) = checkpoint(block_seq, cfg, lp, x, positions, tab,
                                   window=window, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            x, (k, v) = block_seq(cfg, lp, x, positions, tab,
                                  window=window)
        if collect_kv:
            ks.append(k)
            vs.append(v)
    if last_only:
        x = x[:, -1:].contiguous()
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    kvs = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    return logits, 0.0, kvs


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------

def stacked_kv(cfg: ModelConfig, n: int, batch: int, max_len: int,
               run: RunConfig, device="cuda"):
    """One cache buffer (k or v) of zeros for n attention layers: (n, B,
    max_len, KV, D) in ``run.kv_cache_dtype`` (int8: a dict of q and
    scales, each stacked)."""
    buf = kv_cache.alloc(batch, max_len, cfg.num_kv_heads,
                         cfg.resolved_head_dim, run.kv_cache_dtype, device)
    if isinstance(buf, dict):
        return {k: v.expand((n,) + v.shape).clone() for k, v in buf.items()}
    return buf.expand((n,) + buf.shape).clone()


def init_cache(cfg: ModelConfig, batch: int, max_len: int, run: RunConfig,
               device="cuda"):
    """{"pos": (B,) int32, "k"/"v": (L, B, max_len, KV, D)} of zeros
    (int8: dicts of q and scales).  ``device="meta"`` gives shapes
    only."""
    check_run(cfg, run)
    L = cfg.num_layers
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": stacked_kv(cfg, L, batch, max_len, run, device),
            "v": stacked_kv(cfg, L, batch, max_len, run, device)}


def write_stacked(buf, new: torch.Tensor, pos: torch.Tensor):
    """kv_cache.write_ over a leading layer axis, in place: buf
    (L, B, S, ...) and new (L, B, S_new, ...) fold L into the batch."""
    L, B = new.shape[0], new.shape[1]
    flat_pos = pos.repeat(L)

    def fold(t):
        return t.reshape((L * B,) + t.shape[2:])
    if isinstance(buf, dict):
        kv_cache.write_({k: fold(v) for k, v in buf.items()}, fold(new),
                        flat_pos)
    else:
        kv_cache.write_(fold(buf), fold(new), flat_pos)
    return buf


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_len: int,
            run: RunConfig, extras: Optional[dict] = None):
    """Run the full prompt, build a max_len cache.  Returns (logits,
    cache)."""
    B, S = tokens.shape
    logits, _, (k_new, v_new) = forward(
        cfg, params, tokens, run, extras, collect_kv=True,
        last_only=run.prefill_logits == "last")
    cache = init_cache(cfg, B, max_len, run, tokens.device)
    pos0 = torch.zeros((B,), dtype=torch.int32, device=tokens.device)
    write_stacked(cache["k"], k_new, pos0)
    write_stacked(cache["v"], v_new, pos0)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    return logits, cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                run: RunConfig, extras: Optional[dict] = None):
    """token: (B, 1) -> (logits (B, 1, V), updated cache).  The updated
    cache is a copy; the one passed in is left as it was."""
    check_run(cfg, run)
    pos = cache["pos"]
    x = embed(params["embed"], token)
    kc_all, vc_all = kv_cache.clone(cache["k"]), kv_cache.clone(cache["v"])
    # shared by every layer: rotary tables and cache write slots
    tab = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    S = (kc_all["q"] if isinstance(kc_all, dict) else kc_all).shape[2]
    index = kv_cache.write_index(pos, 1, S)
    for i in range(cfg.num_layers):
        x = block_decode(cfg, layer_params(params["layers"], i), x, pos,
                          layer_params(kc_all, i), layer_params(vc_all, i),
                          run, tab, index)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, dict(cache, k=kc_all, v=vc_all, pos=pos + 1)
