"""Whisper-tiny [arXiv:2212.04356] in PyTorch: an encoder-decoder
transformer over stub frame embeddings.

The port of ``repro.models.whisper``: ``schema``, ``encode``,
``forward``, ``init_cache``, ``prefill`` and ``decode_step`` (both of
the reference's branches: the default one, and
``decode_inplace_cache``, whose self attention runs over the cache as
it was before the write with the new token out of band, in plain
torch; only that branch honours ``decode_slice_reads``, as in the
reference).  The mel-spectrogram and conv front end is a stub, as
in the reference: the model reads precomputed frame embeddings
``extras["audio_frames"]`` (B, num_audio_frames, d_model)
(``models.api.extra_input_specs``).

Encoder: bidirectional self attention over the frames, no rotary.
Decoder, per layer: causal self attention (rotary), cross attention to
the encoder output (no rotary, not causal), then the MLP; layernorm and
the tanh GELU.  Layer weights stay stacked ``(L, ...)`` and Python loops
over layer views take the place of the reference's ``lax.scan``.

Per prefill: one flash-attention call per encoder layer, two per decoder
layer (self and cross); per decode step two flash-decode calls per
decoder layer (one, the cross one, under ``decode_inplace_cache``), the
cross one over the cross cache with ``cur_len = num_audio_frames``.  Whisper's norms are layernorms: no RMSNorm launch.
The cache holds ``pos``, the self k/v (L, B, max_len, KV, D) and the
cross k/v (L, B, num_audio_frames, KV, D), written once at prefill.
``forward`` is differentiable, the frames and the encoder included;
``remat="block"`` recomputes each decoder layer in the backward (a
``torch.utils.checkpoint`` where the reference ``jax.checkpoint``s its
decoder scan body; the encoder is not recomputed, as in the reference),
and "group" and "full" do nothing.

Under a device mesh the frames and tokens are split on ``data``, the
encoder's and each decoder layer's output constrained as the
reference's, the attention kernels reached through ``local_map``
(``layers``), and the cache placed by ``shardings.cache_pspecs`` (the
cross caches never split along the frames).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig, RunConfig
from repro_torch.models import kv_cache
from repro_torch.models.layers import (
    apply_mlp, apply_norm, attn_schema, chunked_attention, decode_attention,
    embed, embed_schema, mlp_schema, norm_schema, out_project, q_project,
    qkv_project, rope_tables, unembed)
from repro_torch.models.params import constrain, is_dtensor, shard_batch
from repro_torch.models.transformer import (
    check_run, decode_inplace, layer_params, place_cache, segment,
    stack_schema, stacked_kv, step_buffers, unstack, write_prefill)


def _enc_layer_schema(cfg):
    return {"ln1": norm_schema(cfg), "attn": attn_schema(cfg),
            "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg)}


def schema(cfg: ModelConfig):
    dec_layer = {"ln1": norm_schema(cfg), "attn": attn_schema(cfg),
                 "ln_cross": norm_schema(cfg), "cross": attn_schema(cfg),
                 "ln2": norm_schema(cfg), "mlp": mlp_schema(cfg)}
    return {
        "embed": embed_schema(cfg),
        "enc_layers": stack_schema(_enc_layer_schema(cfg),
                                   cfg.encoder_layers),
        "enc_norm": norm_schema(cfg),
        "dec_layers": stack_schema(dec_layer, cfg.num_layers),
        "final_norm": norm_schema(cfg),
    }


def encode(cfg: ModelConfig, params, frames: torch.Tensor, run: RunConfig):
    """frames: (B, F, d) stub embeddings -> encoder output (B, F, d)
    (under a mesh the frames are sharded on ``data`` first)."""
    x = shard_batch(params, frames).to(params["embed"]["tok"].dtype)
    for lp in unstack(params["enc_layers"]):
        h = apply_norm(cfg, lp["ln1"], x)
        q, k, v = qkv_project(cfg, lp["attn"], h, rope=False)
        x = x + out_project(lp["attn"], chunked_attention(q, k, v,
                                                          causal=False))
        x = x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
        x = constrain(x, ("batch", "seq", "embed"))
    return apply_norm(cfg, params["enc_norm"], x)


def _dec_layer_seq(cfg: ModelConfig, lp, x, enc_out, positions, tab,
                   run: RunConfig):
    """One decoder layer over the sequence: causal self attention, cross
    attention to the encoder output, the MLP.  Returns (x, (k, v, ck,
    cv))."""
    h = apply_norm(cfg, lp["ln1"], x)
    q, k, v = qkv_project(cfg, lp["attn"], h, positions=positions,
                          rope_tab=tab)
    o = chunked_attention(q, k, v, causal=True, window=run.decode_window)
    x = x + out_project(lp["attn"], o)
    h = apply_norm(cfg, lp["ln_cross"], x)
    cq, ck, cv = qkv_project(cfg, lp["cross"], h, kv_x=enc_out, rope=False)
    x = x + out_project(lp["cross"],
                        chunked_attention(cq, ck, cv, causal=False))
    x = x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
    return constrain(x, ("batch", "seq", "embed")), (k, v, ck, cv)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, run: RunConfig,
            extras: Optional[dict] = None, collect_kv: bool = False,
            last_only: bool = False):
    """Teacher-forced decoder over the encoded frames: tokens (B, S) ->
    (logits, 0.0, kvs or None); kvs (when collect_kv) are the stacked
    (k, v, ck, cv), each (L, B, ·, KV, D)."""
    check_run(cfg, run)
    S = tokens.shape[1]
    enc_out = encode(cfg, params, extras["audio_frames"], run)
    tokens = shard_batch(params, tokens)
    x = constrain(embed(params["embed"], tokens), ("batch", "seq", "embed"))
    positions = torch.arange(S, dtype=torch.float32,
                             device=tokens.device)[None]
    tab = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    kvs = []
    for lp in unstack(params["dec_layers"]):
        x, kv = segment(run.remat == "block", _dec_layer_seq, cfg, lp, x,
                        enc_out, positions, tab, run)
        if collect_kv:
            kvs.append(kv)
    if last_only:
        x = x[:, -1:].contiguous()
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    if not collect_kv:
        return logits, 0.0, None
    return logits, 0.0, tuple(torch.stack(t) for t in zip(*kvs))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, run: RunConfig,
               device="cuda", mesh=None):
    """A cache of zeros (see the module docstring); ``device="meta"``
    gives shapes only.  With a device ``mesh`` (and rules installed),
    DTensors placed by ``shardings.cache_pspecs`` (the cross caches
    never split along their frames)."""
    check_run(cfg, run)
    if mesh is not None:
        return place_cache(cfg, run, init_cache(cfg, batch, max_len, run,
                                                device), mesh)
    L, F = cfg.num_layers, cfg.num_audio_frames
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=device),
            "k": stacked_kv(cfg, L, batch, max_len, run, device),
            "v": stacked_kv(cfg, L, batch, max_len, run, device),
            "cross_k": stacked_kv(cfg, L, batch, F, run, device),
            "cross_v": stacked_kv(cfg, L, batch, F, run, device)}


def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_len: int,
            run: RunConfig, extras: Optional[dict] = None):
    """Encode the frames, run the prompt, build a max_len cache with the
    cross k/v of every decoder layer.  Returns (logits, cache)."""
    B, S = tokens.shape
    logits, _, (k, v, ck, cv) = forward(
        cfg, params, tokens, run, extras, collect_kv=True,
        last_only=run.prefill_logits == "last")
    return logits, write_prefill(
        cfg, run, params, {"k": k, "v": v, "cross_k": ck, "cross_v": cv},
        B, S, max_len, tokens.device, init=init_cache)


def decode_step(cfg: ModelConfig, params, token: torch.Tensor, cache,
                run: RunConfig, extras: Optional[dict] = None):
    """token: (B, 1) -> (logits (B, 1, V), updated cache).  The self k/v
    are copies (under ``decode_inplace_cache`` the buffers passed in,
    written in place); the cross k/v, which a step only reads, are
    shared with the cache passed in, which is otherwise left as it
    was."""
    check_run(cfg, run)
    pos = cache["pos"]
    token = shard_batch(params, token)
    x = constrain(embed(params["embed"], token), ("batch", None, "embed"))
    kc_all, vc_all = step_buffers(cache, run)
    tab = rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    S = (kc_all["q"] if isinstance(kc_all, dict) else kc_all).shape[-3]
    index = None if is_dtensor(pos) else kv_cache.write_index(pos, 1, S)
    mem_len = shard_batch(params, torch.full(
        (token.shape[0],), cfg.num_audio_frames, dtype=torch.int32,
        device=token.device))
    for i in range(cfg.num_layers):
        lp = layer_params(params["dec_layers"], i)
        kc, vc = layer_params(kc_all, i), layer_params(vc_all, i)
        h = apply_norm(cfg, lp["ln1"], x)
        q, k, v = qkv_project(cfg, lp["attn"], h, positions=pos[:, None],
                              rope_tab=tab)
        if run.decode_inplace_cache:
            o = decode_inplace(q, k, v, kc, vc, pos, run, index)
        else:
            kv_cache.write_(kc, k, pos, index)
            kv_cache.write_(vc, v, pos, index)
            o = decode_attention(q, kv_cache.read(kc), kv_cache.read(vc),
                                 pos + 1, window=run.decode_window)
        x = x + out_project(lp["attn"], o)
        h = apply_norm(cfg, lp["ln_cross"], x)
        co = decode_attention(q_project(lp["cross"], h),
                              kv_cache.read(layer_params(cache["cross_k"], i)),
                              kv_cache.read(layer_params(cache["cross_v"], i)),
                              mem_len)
        x = x + out_project(lp["cross"], co)
        x = x + apply_mlp(cfg, lp["mlp"], apply_norm(cfg, lp["ln2"], x))
    x = apply_norm(cfg, params["final_norm"], x)
    logits = unembed(cfg, params["embed"], x)
    return logits, dict(cache, k=kc_all, v=vc_all, pos=pos + 1)
