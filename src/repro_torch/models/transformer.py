"""Decoder-only transformer LM, dense, MoE and VLM families, in PyTorch.

The port of ``repro.models.transformer`` for the dense family
(``tinyllama-1.1b``), the MoE family (``deepseek-moe-16b``,
``qwen3-moe-30b-a3b``: each layer's MLP is ``models/moe.py``'s routed
experts) and the VLM family (``llama-3.2-vision-90b``: groups of
``cross_attn_every - 1`` self layers and one cross-attention layer over
the vision embeddings, its two residuals scaled by tanh gates):
``schema``, ``forward``, ``init_cache``, ``prefill`` and
``decode_step``.  Layer weights stay *stacked* (each leaf ``(L, ...)``,
or ``(G, n_self, ...)`` and ``(G, ...)`` in the VLM's groups, as the
reference keeps them), and Python loops over layer views take the place
of the reference's ``lax.scan``.

Per forward: 2 RMSNorms per layer plus the final one (45 at 22 layers),
2 more per layer with per-head q/k norm (qwen3: 4L+1), one
flash-attention call per layer at prefill and one flash-decode call per
layer at each decode step; a cross layer counts as a layer (its
attention runs over the memory, not causal, and its decode over the
cross cache of ``num_vision_tokens`` rows).  ``forward`` returns the
MoE load-balance loss summed over layers, as the reference's scan carry
does; ``prefill`` and ``decode_step`` drop it.

The default decode path is the reference's non-in-place one: each step
returns a new cache and leaves the caller's as it was.  The serving
knobs of ``RunConfig`` follow the reference:

* ``decode_inplace_cache``: the step writes the caller's cache buffers
  in place (no copy of the cache a step) and returns them.  Each
  attention layer attends over its cache as it was before the write,
  with the new token out of band (``layers.decode_attention_with_new``,
  plain torch, as the reference's jnp), so this branch launches no
  decode_attention kernel for self attention; the VLM's cross layers
  still do.
* ``decode_uniform_pos`` (with the in-place branch): every row is
  written at ``pos[0]`` (``kv_cache.write_layer``).
* ``decode_slice_reads`` (with ``decode_window``): attention reads a
  copy of the ``decode_window`` rows from ``min(pos) + 1 - w`` on, for
  the whole batch, so a row far ahead of the slowest one loses its
  keys past the slice, as in the reference.
* ``prefill_parallel_q``: accepted; it changes nothing here, since the
  flash kernel already runs every q tile in parallel (the reference
  vectorises its jnp path's q chunks with it).

``forward`` is differentiable in every family here (the training
path), with the reference's ``remat``, each checkpoint a
``torch.utils.checkpoint`` in place of its ``jax.checkpoint``:
``"block"`` recomputes each self layer in the backward (the reference's
scan body); ``"group"`` recomputes each of the VLM's groups, its self
layers and its cross layer (the reference's group body), and does
nothing without cross-attention; ``"full"`` does nothing.

Sharded over a device mesh (every family: the other models call
``check_run``, ``place_cache`` and this module's blocks too): params are
DTensors placed by ``launch.shardings.model_param_pspecs`` (``fsdp``
moves the weights' ``embed`` axis onto ``data``), the rules installed
with ``params.use_rules``.  Tokens and the modality inputs are sharded
on ``data``, activations constrained where the reference constrains
them, the kernels run on each rank's block (``layers``), the cache
(the VLM's cross caches too) is placed by
``launch.shardings.cache_pspecs`` and written on each rank's block
(``kv_cache``).  With ``shard_kv_seq`` (or rules that put ``kv_seq`` on
a mesh axis) each rank holds a block of the self caches' rows, and
decode attention merges the ranks' blocks by log-sum-exp
(``layers.decode_attention``).  ``decode_slice_reads`` takes its window
from the smallest position of the whole batch (``_slice_start``), and
over a sequence-split cache each rank reads the window's part in its
block.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import kv_cache
from repro_torch.models.layers import (
    apply_mlp, apply_norm, attn_schema, chunked_attention, decode_attention,
    decode_attention_with_new, embed, embed_schema, mlp_schema, norm_schema,
    out_project, q_project, qkv_project, rope_tables, unembed)
from repro_torch.models.moe import apply_moe, moe_schema
from repro_torch.models.params import (P, active_rules, constrain,
                                       is_dtensor, local_call, map_schema,
                                       mesh_of, seq_dims, shard_batch)

# the families that run under a device mesh: all six
SHARDED_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


def segment(recompute: bool, fn, *args, **kw):
    """``fn(*args, **kw)``, recomputed in the backward when
    ``recompute`` (``torch.utils.checkpoint``, in place of the
    reference's ``jax.checkpoint``).  The models draw no random numbers,
    so no RNG state is kept."""
    if recompute:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)
    return fn(*args, **kw)


def check_run(cfg: ModelConfig, run: RunConfig) -> None:
    """Raise for a family the port does not know or an unknown
    ``prefill_logits``; every other knob runs in every family, on one
    device and under a mesh."""
    if cfg.family not in SHARDED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    if run.prefill_logits not in ("all", "last"):
        raise ValueError(f"prefill_logits={run.prefill_logits!r}")


def place_cache(cfg: ModelConfig, run: RunConfig, cache, mesh):
    """Every leaf of ``cache`` (whole tensors, or DTensors) placed on
    ``mesh`` by ``launch.shardings.cache_pspecs`` under the installed
    rules (a DTensor already placed so passes as it is)."""
    from repro_torch.launch import shardings
    return shardings.distribute(
        cache, mesh, shardings.cache_pspecs(cfg, run, active_rules() or {}))


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def stack_schema(sub, n: int):
    """Every leaf of ``sub`` with a leading layer axis of size n."""
    return map_schema(lambda p, _path: P((n,) + p.shape, ("layers",) + p.axes,
                                         init=p.init, scale=p.scale), sub)


def _layer_schema(cfg: ModelConfig):
    s = {"ln1": norm_schema(cfg), "attn": attn_schema(cfg),
         "ln2": norm_schema(cfg)}
    if cfg.is_moe:
        s["moe"] = moe_schema(cfg)
    else:
        s["mlp"] = mlp_schema(cfg)
    return s


def _cross_layer_schema(cfg: ModelConfig):
    return {"ln1": norm_schema(cfg), "attn": attn_schema(cfg),
            "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg),
            "gate_attn": P((1,), (None,), init="zeros"),
            "gate_mlp": P((1,), (None,), init="zeros")}


def cross_groups(cfg: ModelConfig):
    """(groups, self layers a group) of a VLM config; layers past the
    last whole group are dropped, as in the reference."""
    return cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def schema(cfg: ModelConfig):
    s = {"embed": embed_schema(cfg), "final_norm": norm_schema(cfg)}
    if cfg.cross_attn_every:
        G, n_self = cross_groups(cfg)
        s["groups"] = {
            "self": stack_schema(stack_schema(_layer_schema(cfg), n_self), G),
            "cross": stack_schema(_cross_layer_schema(cfg), G)}
    else:
        s["layers"] = stack_schema(_layer_schema(cfg), cfg.num_layers)
    return s


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

def _ffn(cfg, lp, h, run: RunConfig):
    """The layer's MLP, or its routed experts: (out, aux)."""
    if cfg.is_moe:
        return apply_moe(cfg, lp["moe"], h,
                         capacity_factor=run.moe_capacity_factor)
    return apply_mlp(cfg, lp["mlp"], h), 0.0


def block_seq(cfg, lp, x, positions, rope_tab, run: RunConfig,
              window: int = 0, causal: bool = True):
    """One layer over a full sequence; returns (x, aux, (k, v))."""
    q, k, v = qkv_project(cfg, lp["attn"], apply_norm(cfg, lp["ln1"], x),
                          positions=positions, rope_tab=rope_tab)
    o = chunked_attention(q, k, v, causal=causal, window=window)
    x = constrain(x + out_project(lp["attn"], o), ("batch", "seq", "embed"))
    h, aux = _ffn(cfg, lp, apply_norm(cfg, lp["ln2"], x), run)
    return constrain(x + h, ("batch", "seq", "embed")), aux, (k, v)


def block_decode(cfg, lp, x, pos, kc, vc, run: RunConfig, rope_tab, index,
                 slice_reads: bool = True):
    """Single-token decode for one layer.  x: (B,1,d); pos: (B,) write
    index; kc/vc: this layer's cache buffers (views), written in place
    at ``index`` (``kv_cache.write_index``); rope_tab: the rotary tables
    of ``pos``.  Returns (x, aux).

    The reference's ``_block_decode`` (write, then attend over the
    written cache through the decode kernel), or under
    ``decode_inplace_cache`` its ``_block_decode_inplace``: attend over
    the cache as it was, the new token out of band, then write (at
    ``pos[0]`` for every row with ``decode_uniform_pos``).
    ``slice_reads`` False: the write-then-attend branch reads the whole
    cache whatever ``decode_slice_reads`` says (zamba2's, as in the
    reference)."""
    h = apply_norm(cfg, lp["ln1"], x)
    q, k, v = qkv_project(cfg, lp["attn"], h, positions=pos[:, None],
                          rope_tab=rope_tab)
    if run.decode_inplace_cache:
        o = decode_inplace(q, k, v, kc, vc, pos, run, index)
    else:
        kv_cache.write_(kc, k, pos, index)
        kv_cache.write_(vc, v, pos, index)
        o = _decode_attend(q, kc, vc, pos, run, slice_reads)
    x = x + out_project(lp["attn"], o)
    h, aux = _ffn(cfg, lp, apply_norm(cfg, lp["ln2"], x), run)
    return x + h, aux


def cross_attn_seq(cfg, lp, x, memory):
    """The VLM's cross layer over a full sequence: attention of x to the
    memory (no rotary, not causal), then the MLP, each residual scaled
    by the tanh of its gate.  Returns (x, (k, v)) with k, v over the
    memory."""
    h = apply_norm(cfg, lp["ln1"], x)
    q, k, v = qkv_project(cfg, lp["attn"], h, kv_x=memory, rope=False)
    o = chunked_attention(q, k, v, causal=False)
    x = x + torch.tanh(lp["gate_attn"]) * out_project(lp["attn"], o)
    h = apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
    x = x + torch.tanh(lp["gate_mlp"]) * h
    return constrain(x, ("batch", "seq", "embed")), (k, v)


def cross_attn_decode(cfg, lp, x, ck, cv, memory_len):
    """The VLM's cross layer for one token over the cross cache ck, cv
    (B, Tv, KV, D), of which ``memory_len`` (B,) rows are valid."""
    h = apply_norm(cfg, lp["ln1"], x)
    q = q_project(lp["attn"], h)
    if cfg.use_qkv_bias:
        q = q + lp["attn"]["bq"]
    o = decode_attention(q, kv_cache.read(ck), kv_cache.read(cv), memory_len)
    x = x + torch.tanh(lp["gate_attn"]) * out_project(lp["attn"], o)
    h = apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
    return x + torch.tanh(lp["gate_mlp"]) * h


def _slice_start(kc, pos, run: RunConfig):
    """(start, w) of ``decode_slice_reads``' window of one layer's cache:
    w = min(decode_window, S) rows from clip(min(pos) + 1 - w, 0, S - w),
    one start for the whole batch, left on the device; None when the
    knob is off.  Under a mesh min(pos) is the whole batch's: each
    rank's minimum, all-reduced over the mesh dims that split the batch,
    so ``start`` is a plain 0-d tensor, the same on every rank."""
    if not (run.decode_slice_reads and run.decode_window):
        return None
    S = (kc["q"] if isinstance(kc, dict) else kc).shape[1]
    w = min(run.decode_window, S)
    if is_dtensor(pos):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import Shard
        low = pos.to_local().min()
        for i, p in enumerate(pos.placements):
            if isinstance(p, Shard):
                low = funcol.all_reduce(low, "min", (pos.device_mesh, i))
    else:
        low = pos.min()
    return torch.clamp(low + 1 - w, 0, S - w), w


def _on_rows(fn, t):
    """``fn`` on a per-row tensor (pos (B,)), on each rank's rows of a
    DTensor."""
    if not is_dtensor(t):
        return fn(t)
    return local_call(fn, tuple(t.placements), t)


def _window_rows(kc, start, w):
    """The window's copy (``kv_cache.slice_window``) of a cache whose
    sequence axis is whole on every rank: each rank copies its block's
    rows."""
    def sl(t):
        if not is_dtensor(t):
            return kv_cache.slice_window(t, start, w)
        return local_call(lambda a: kv_cache.slice_window(a, start, w),
                          tuple(t.placements), t)
    if isinstance(kc, dict):
        return {k: sl(v) for k, v in kc.items()}
    return sl(kc)


def _seq_split(kc) -> bool:
    return bool(seq_dims(kc["q"] if isinstance(kc, dict) else kc))


def _decode_attend(q, kc, vc, pos, run: RunConfig, slice_reads=True):
    """Attention over one layer's written cache through the decode
    kernel; with ``decode_slice_reads`` (and ``slice_reads``) over a
    copy of the window's rows only, each row's valid length counted
    from the window's start.  Over a cache split along its sequence
    axis each rank's block kernel reads only its rows of the window
    (``span``): no copy."""
    sl = _slice_start(kc, pos, run) if slice_reads else None
    cur = pos + 1
    if sl is not None:
        start, w = sl
        if _seq_split(kc):
            return decode_attention(q, kv_cache.read(kc), kv_cache.read(vc),
                                    cur, window=run.decode_window,
                                    span=(start, w))
        kc, vc = _window_rows(kc, start, w), _window_rows(vc, start, w)
        cur = _on_rows(lambda p: p + 1 - start, pos)
    return decode_attention(q, kv_cache.read(kc), kv_cache.read(vc), cur,
                            window=run.decode_window)


def decode_inplace(q, k, v, kc, vc, pos, run: RunConfig, index):
    """The in-place branch's attention and write for one layer (the
    reference's ``_decode_attend_prewrite`` and ``write_layer``): attend
    over the layer's cache kc, vc as it was before this step's write,
    or with ``decode_slice_reads`` its window's rows, plus the new token
    k, v out of band, in plain torch; then write k, v in place (at
    ``pos[0]`` for every row with ``decode_uniform_pos``; ``index``:
    the step's ``kv_cache.write_index``).  Returns the attention
    output."""
    k_old, v_old, cur, span = kc, vc, pos, None
    sl = _slice_start(kc, pos, run)
    if sl is not None:
        start, w = sl
        if _seq_split(kc):
            span = sl
        else:
            k_old, v_old = _window_rows(kc, start, w), \
                _window_rows(vc, start, w)
            cur = _on_rows(lambda p: p - start, pos)
    o = decode_attention_with_new(q, kv_cache.read(k_old),
                                  kv_cache.read(v_old), k, v, cur,
                                  window=run.decode_window, span=span)
    for buf, new in ((kc, k), (vc, v)):
        kv_cache.write_layer(buf, (), new, pos,
                             uniform=run.decode_uniform_pos, index=index)
    return o


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, tokens: torch.Tensor, run: RunConfig,
            extras: Optional[dict] = None, collect_kv: bool = False,
            last_only: bool = False):
    """tokens: (B, S) -> (logits, aux, kvs or None).  aux is the MoE
    load-balance loss summed over layers (0.0 in the dense family); kvs
    (when collect_kv) are stacked per-layer (L, B, S, KV, D) pairs, the
    prefill cache; in the VLM ((k, v) each (G, n_self, B, S, KV, D),
    (ck, cv) each (G, B, Tv, KV, D)), as the reference's scan stacks
    them.  The VLM reads ``extras["vision_embeds"]`` (B, Tv, d)."""
    check_run(cfg, run)
    S = tokens.shape[1]
    tokens = shard_batch(params, tokens)
    x = constrain(embed(params["embed"], tokens), ("batch", "seq", "embed"))
    positions = torch.arange(S, dtype=torch.float32,
                             device=tokens.device)[None]
    window = run.decode_window or 0
    tab = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def layer(lp, x):
        return segment(run.remat == "block", block_seq, cfg, lp, x,
                       positions, tab, run, window=window)

    def group(gself, gcross, x, memory):
        """One VLM group: its self layers, then its cross layer.
        Returns (x, aux, its stacked self (k, v) and its cross (k, v),
        or None without collect_kv)."""
        aux, gk, gv = 0.0, [], []
        for lp in unstack(gself):
            x, a, (k, v) = layer(lp, x)
            aux = aux + a
            gk.append(k)
            gv.append(v)
        x, ckv = cross_attn_seq(cfg, gcross, x, memory)
        if not collect_kv:
            return x, aux, None
        return x, aux, ((torch.stack(gk), torch.stack(gv)), ckv)

    ks, vs, cks, cvs, aux = [], [], [], [], 0.0
    if cfg.cross_attn_every:
        memory = shard_batch(params, extras["vision_embeds"]).to(x.dtype)
        groups = params["groups"]
        for gself, gcross in zip(unstack(groups["self"]),
                                 unstack(groups["cross"])):
            x, a, kvs = segment(run.remat == "group", group, gself, gcross,
                                x, memory)
            aux = aux + a
            if collect_kv:
                (gk, gv), (ck, cv) = kvs
                ks.append(gk)
                vs.append(gv)
                cks.append(ck)
                cvs.append(cv)
    else:
        for lp in unstack(params["layers"]):
            x, a, (k, v) = layer(lp, x)
            aux = aux + a
            if collect_kv:
                ks.append(k)
                vs.append(v)
    if last_only:
        x = x[:, -1:].contiguous()
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    kvs = None
    if collect_kv:
        kvs = (torch.stack(ks), torch.stack(vs))
        if cfg.cross_attn_every:
            kvs = (kvs, (torch.stack(cks), torch.stack(cvs)))
    return logits, aux, kvs


# ---------------------------------------------------------------------------
# Decode (single token, KV cache)
# ---------------------------------------------------------------------------

def stacked_kv(cfg: ModelConfig, n, batch: int, max_len: int,
               run: RunConfig, device="cuda"):
    """One cache buffer (k or v) of zeros for n attention layers (n an
    int, or a tuple of leading axes): (*n, B, max_len, KV, D) in
    ``run.kv_cache_dtype`` (int8: a dict of q and scales, each
    stacked)."""
    lead = (n,) if isinstance(n, int) else tuple(n)
    buf = kv_cache.alloc(batch, max_len, cfg.num_kv_heads,
                         cfg.resolved_head_dim, run.kv_cache_dtype, device)
    if isinstance(buf, dict):
        return {k: v.expand(lead + v.shape).clone() for k, v in buf.items()}
    return buf.expand(lead + buf.shape).clone()


def init_cache(cfg: ModelConfig, batch: int, max_len: int, run: RunConfig,
               device="cuda", mesh=None):
    """{"pos": (B,) int32, "k"/"v": (L, B, max_len, KV, D)} of zeros
    (int8: dicts of q and scales); the VLM's "k"/"v" are (G, n_self, B,
    max_len, KV, D), and its "cross_k"/"cross_v" (G, B, Tv, KV, D).
    ``device="meta"`` gives shapes only.  With a device ``mesh`` (and
    rules installed), DTensors placed by ``shardings.cache_pspecs``."""
    check_run(cfg, run)
    if mesh is not None:
        return place_cache(cfg, run, init_cache(cfg, batch, max_len, run,
                                                device), mesh)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.cross_attn_every:
        G, n_self = cross_groups(cfg)
        Tv = cfg.num_vision_tokens
        return {"pos": pos,
                "k": stacked_kv(cfg, (G, n_self), batch, max_len, run,
                                device),
                "v": stacked_kv(cfg, (G, n_self), batch, max_len, run,
                                device),
                "cross_k": stacked_kv(cfg, G, batch, Tv, run, device),
                "cross_v": stacked_kv(cfg, G, batch, Tv, run, device)}
    L = cfg.num_layers
    return {"pos": pos,
            "k": stacked_kv(cfg, L, batch, max_len, run, device),
            "v": stacked_kv(cfg, L, batch, max_len, run, device)}


def step_buffers(cache, run: RunConfig):
    """The k and v buffers a decode step writes: the cache's own under
    ``decode_inplace_cache``, copies otherwise."""
    if run.decode_inplace_cache:
        return cache["k"], cache["v"]
    return kv_cache.clone(cache["k"]), kv_cache.clone(cache["v"])


def write_stacked(buf, new: torch.Tensor, pos: torch.Tensor, block=None):
    """kv_cache.write_ over the leading layer axes, in place: buf
    (*lead, B, S, ...) and new (*lead, B, S_new, KV, D) fold the lead
    axes into the batch.  On DTensors each rank writes its blocks
    (``block``: ``kv_cache.local_blocks``' for a sequence-split
    buffer)."""
    nl = new.dim() - 4
    if is_dtensor(buf["q"] if isinstance(buf, dict) else buf):
        write_stacked(*kv_cache.local_blocks(buf, new, pos, nl))
        return buf
    n, B = math.prod(new.shape[:nl]), new.shape[nl]
    flat_pos = pos.repeat(n)

    def fold(t):
        return t.reshape((n * B,) + t.shape[nl + 1:])
    if isinstance(buf, dict):
        kv_cache.write_({k: fold(v) for k, v in buf.items()}, fold(new),
                        flat_pos, block=block)
    else:
        kv_cache.write_(fold(buf), fold(new), flat_pos, block=block)
    return buf


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_len: int,
            run: RunConfig, extras: Optional[dict] = None):
    """Run the full prompt, build a max_len cache.  Returns (logits,
    cache)."""
    B, S = tokens.shape
    logits, _, kvs = forward(
        cfg, params, tokens, run, extras, collect_kv=True,
        last_only=run.prefill_logits == "last")
    writes = dict(zip(("k", "v"), kvs))
    if cfg.cross_attn_every:
        writes = dict(zip(("k", "v"), kvs[0]),
                      **dict(zip(("cross_k", "cross_v"), kvs[1])))
    return logits, write_prefill(cfg, run, params, writes, B, S, max_len,
                                 tokens.device)


def write_prefill(cfg: ModelConfig, run: RunConfig, params, writes: dict,
                  B: int, S: int, max_len: int, device, init=None):
    """A new max_len cache (``init``: the model's ``init_cache``, this
    module's by default) with each stacked (*lead, B, S_new, KV, D)
    buffer of ``writes`` written from position 0 and ``pos`` at S.
    Under a mesh the cache is placed by ``cache_pspecs`` and each rank
    writes its blocks."""
    init = init or init_cache
    cache = init(cfg, B, max_len, run, device, mesh=mesh_of(params))
    pos0 = shard_batch(params, torch.zeros((B,), dtype=torch.int32,
                                           device=device))
    for name, new in writes.items():
        write_stacked(cache[name], new, pos0)
    cache["pos"] = shard_batch(params, torch.full(
        (B,), S, dtype=torch.int32, device=device))
    return cache


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                run: RunConfig, extras: Optional[dict] = None):
    """token: (B, 1) -> (logits (B, 1, V), updated cache).  The updated
    cache is a copy (the VLM's cross cache, which a step only reads, is
    shared with it); the one passed in is left as it was.  Under
    ``decode_inplace_cache`` the k and v buffers passed in are written
    in place and returned (``pos`` is new either way)."""
    check_run(cfg, run)
    pos = cache["pos"]
    token = shard_batch(params, token)
    x = constrain(embed(params["embed"], token), ("batch", None, "embed"))
    kc_all, vc_all = step_buffers(cache, run)
    # shared by every layer: rotary tables and cache write slots
    tab = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    S = (kc_all["q"] if isinstance(kc_all, dict) else kc_all).shape[-3]
    index = None if is_dtensor(pos) else kv_cache.write_index(pos, 1, S)
    if cfg.cross_attn_every:
        G, n_self = cross_groups(cfg)
        mem_len = shard_batch(params, torch.full(
            (token.shape[0],), cfg.num_vision_tokens, dtype=torch.int32,
            device=token.device))
        for g in range(G):
            gself = layer_params(params["groups"]["self"], g)
            kc, vc = layer_params(kc_all, g), layer_params(vc_all, g)
            for i in range(n_self):
                x, _ = block_decode(cfg, layer_params(gself, i), x, pos,
                                    layer_params(kc, i), layer_params(vc, i),
                                    run, tab, index)
            x = cross_attn_decode(
                cfg, layer_params(params["groups"]["cross"], g), x,
                layer_params(cache["cross_k"], g),
                layer_params(cache["cross_v"], g), mem_len)
    else:
        for i in range(cfg.num_layers):
            x, _ = block_decode(cfg, layer_params(params["layers"], i), x,
                                pos, layer_params(kc_all, i),
                                layer_params(vc_all, i), run, tab, index)
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, dict(cache, k=kc_all, v=vc_all, pos=pos + 1)
