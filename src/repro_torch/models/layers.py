"""Transformer layer primitives, in PyTorch (functional, over plain
param dicts).

The port of ``repro.models.layers``: norms, rotary embeddings (split
halves), the MLP, the attention projections, attention over a full
sequence and over a KV cache, and the embedding.  Leaves keep the
reference's layouts (``wq (d,H,hd)``, ``wo (H,hd,d)``, ``up/gate (d,f)``,
``head (d,V)``).

``rmsnorm``, ``chunked_attention`` and ``decode_attention`` go through
the kernel wrappers: a CPU tensor takes the plain version, a CUDA tensor
the hand-written kernel (or the wrapper raises).  On DTensors (params
sharded over a device mesh, ``repro_torch.launch.shardings``) each
reaches its wrapper through ``params.local_call`` on the rank's local
block: attention with batch on ``data`` and heads on ``model``, the
norms over local rows with the normalised axis replicated, rotary
embeddings on the local rows.  Products with the weights stay DTensor
ops, whose collectives DTensor inserts, and ``apply_mlp`` and
``unembed`` constrain their outputs where the reference does.
``decode_attention_with_new``, the reference's attention of the in-place
decode (``decode_inplace_cache``), is plain torch on every device, as
the reference's is jnp and reaches no Pallas kernel.

A cache whose sequence axis is sharded (``shard_kv_seq``, or the
``--opt`` decode rules' ``kv_seq`` on ``model``) is attended block by
block: q, which is small, is replicated along the mesh dims that split
the sequence, each rank attends over its block of rows at their global
positions, and the ranks merge their parts by log-sum-exp over those
dims (all-reduces of a max and of sums, ``seq_blocks``).  No rank
gathers the cache.  This is the flash-decode over the sequence whose
softmax the reference leaves to XLA's cross-shard reductions.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models.params import (P, constrain, is_dtensor,
                                       local_call, redistribute,
                                       rule_active, seq_blocks, seq_dims,
                                       shard_as_placements, whole_along)

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """The reference's ``layers.rmsnorm`` (f32 statistics, output in x's
    type), through the RMSNorm kernel's wrapper (on a DTensor, over the
    local rows, with the normalised axis and the scale replicated)."""
    if is_dtensor(x):
        x = whole_along(x, x.dim() - 1)
        scale = whole_along(scale, 0)
        return local_call(lambda a, s: rmsnorm_ops.rmsnorm(a, s, eps),
                          tuple(x.placements), x, scale)
    return rmsnorm_ops.rmsnorm(x, scale, eps)


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def norm_schema(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": P((d,), (None,), init="ones")}
    return {"scale": P((d,), (None,), init="ones"),
            "bias": P((d,), (None,), init="zeros")}


def apply_norm(cfg, p, x):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) for ``apply_rope``, each (..., S, 1, D): [cos, cos]
    and [-sin, sin] over the two halves.  One table serves every layer
    of a forward or decode step."""
    if is_dtensor(positions):            # per-row positions (decode)
        pl = tuple(positions.placements)
        return local_call(lambda p: rope_tables(p, head_dim, theta),
                          (pl, pl), positions)
    freqs = rope_freqs(head_dim, theta, positions.device)     # (D/2,)
    angles = positions[..., None].float() * freqs            # (..., S, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([-sin, sin], dim=-1)[..., None, :])


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               tables=None) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  Rotates
    the two halves of each head (not interleaved pairs):
    [x1 cos - x2 sin, x1 sin + x2 cos], written as
    x * [cos, cos] + [x2, x1] * [-sin, sin], which rounds the same.
    ``tables``: ``rope_tables(positions, D, theta)``, when the caller
    has it."""
    cos, sin = tables if tables is not None \
        else rope_tables(positions, x.shape[-1], theta)
    if is_dtensor(x):
        if not is_dtensor(cos):      # one table for the sequence: cut it
            cos, sin = (_along_seq(t, x) for t in (cos, sin))   # as x's
        return local_call(lambda a, c, s: apply_rope(a, None, theta, (c, s)),
                          tuple(x.placements), x, cos, sin)
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


def _along_seq(t: torch.Tensor, x):
    """The plain rotary table t (..., S, 1, D) as a DTensor on x's mesh,
    split along S where x (..., S, H, D) is (sequence parallelism), so
    that each rank's block holds its rows' angles; t itself where x's
    sequence is whole."""
    from torch.distributed.tensor import Replicate, Shard
    split = [isinstance(p, Shard) and p.dim % x.dim() == x.dim() - 3
             for p in x.placements]
    if not any(split):
        return t
    return shard_as_placements(t, x.device_mesh, tuple(
        Shard(t.dim() - 3) if s else Replicate() for s in split))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def mlp_schema(cfg, d_ff=None):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    s = {"up": P((d, f), ("embed", "mlp")),
         "down": P((f, d), ("mlp", "embed"))}
    if cfg.gated_mlp:
        s["gate"] = P((d, f), ("embed", "mlp"))
    return s


def apply_mlp(cfg, p, x):
    act = _act(cfg.activation)
    h = x @ p["up"]
    if cfg.gated_mlp:
        h = h * act(x @ p["gate"])
    else:
        h = act(h)
    h = constrain(h, ("batch", "seq", "mlp"))
    return h @ p["down"]


# ---------------------------------------------------------------------------
# Attention projections
# ---------------------------------------------------------------------------

def attn_schema(cfg):
    d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    s = {"wq": P((d, H, hd), ("embed", "heads", "head_dim")),
         "wk": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
         "wv": P((d, KV, hd), ("embed", "kv_heads", "head_dim")),
         "wo": P((H, hd, d), ("heads", "head_dim", "embed"))}
    if cfg.use_qkv_bias:
        s["bq"] = P((H, hd), ("heads", "head_dim"), init="zeros")
        s["bk"] = P((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        s["bv"] = P((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    if cfg.qk_norm:
        s["q_norm"] = P((hd,), (None,), init="ones")
        s["k_norm"] = P((hd,), (None,), init="ones")
    return s


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads.
    On DTensors w is taken whole along d (fsdp shards it there) first.
    Where no mesh dim splits w's heads (the rules drop ``heads`` when
    the model axis does not divide them: whisper's 6, minitron's 24 on
    16), each rank multiplies its rows by the whole w (``local_call``):
    DTensor's own choice may split the product's columns over the model
    axis, and such columns do not fold back into whole heads."""
    d, h, k = w.shape
    w = whole_along(w, 0)
    if is_dtensor(x) and not any(_splits(p, w, (1,)) for p in w.placements) \
            and not any(_splits(p, x, (2,)) for p in x.placements):
        from torch.distributed.tensor import Replicate
        x = _even_seq(x)
        pl = tuple(p if _splits(p, x, (0, 1)) else Replicate()
                   for p in x.placements)
        return local_call(_project, pl, x, w)
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _even_seq(x):
    """x, or where its sequence (dim 1) is split unevenly (whisper's 1500
    frames on 16) x with the sequence gathered: a function of each
    rank's block (``local_call``) cannot return an uneven block."""
    dims = seq_dims(x)
    if dims and x.shape[1] % seq_blocks.ways(x.device_mesh, dims):
        return whole_along(x, 1)
    return x


def _splits(p, t, dims) -> bool:
    """Placement p splits tensor t along one of ``dims``."""
    from torch.distributed.tensor import Shard
    return isinstance(p, Shard) and p.dim % t.dim() in dims


def q_project(p, x: torch.Tensor) -> torch.Tensor:
    """The query projection alone, einsum("bsd,dhk->bshk") with wq
    (cross-attention decode, whose k and v sit in the cross cache),
    constrained as ``qkv_project``'s."""
    return constrain(_project(x, p["wq"]), ("batch", "seq", "heads", None))


def qkv_project(cfg, p, x, kv_x=None, positions=None, rope: bool = True,
                rope_tab=None):
    """Returns q (B,S,H,D), k/v (B,Skv,KV,D).  ``rope_tab``: the
    ``rope_tables`` of ``positions``, when the caller has them."""
    kv_x = x if kv_x is None else kv_x
    q = q_project(p, x)
    k = constrain(_project(kv_x, p["wk"]), ("batch", "seq", "kv_heads", None))
    v = constrain(_project(kv_x, p["wv"]), ("batch", "seq", "kv_heads", None))
    if cfg.use_qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q.contiguous(), p["q_norm"])
        k = rmsnorm(k.contiguous(), p["k_norm"])
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta, rope_tab)
        k = apply_rope(k, positions, cfg.rope_theta, rope_tab)
    return q, k, v


def out_project(p, o: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd").  On DTensors whose heads are whole on
    every mesh dim (the rules dropped ``heads``), each rank multiplies
    its rows by the whole wo (``local_call``), as ``_project`` does, so
    that no gradient splits the heads' columns."""
    h, k, d = p["wo"].shape
    wo = p["wo"]
    if is_dtensor(o) and not any(_splits(q, o, (2, 3))
                                 for q in o.placements) \
            and not any(_splits(q, wo, (0, 1)) for q in wo.placements):
        from torch.distributed.tensor import Replicate
        o = _even_seq(o)
        pl = tuple(q if _splits(q, o, (0, 1)) else Replicate()
                   for q in o.placements)
        return local_call(lambda a, b: out_project({"wo": b}, a), pl, o,
                          whole_along(wo, 2))
    return o.reshape(*o.shape[:-2], h * k) @ wo.reshape(h * k, d)


# ---------------------------------------------------------------------------
# Attention over a full sequence (prefill)
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_offset: int = 0, parallel_q: bool = False):
    """Softmax attention of q (B,Sq,H,D) over k, v (B,Skv,KV,D) with GQA,
    through the flash-attention kernel's wrapper, with the reference
    jnp path's meaning: query i sits at key position ``q_offset + i``
    (starts aligned by default), masked by ``causal`` and ``window``.

    At Sq == Skv and ``q_offset=0`` this is also what the reference's
    Pallas kernel computes (it aligns the ends).  Continuation attention
    (Sq != Skv under a causal or window mask) takes any ``q_offset >=
    0``, either length the larger; a row whose keys are all masked gets
    0 from the kernel and the mean of v from the plain version (the
    reference's jnp path: the mean over its padded chunks).  Cross
    attention (not causal, no window) masks nothing, so the offset is
    moot there.  ``parallel_q``: the reference vectorises its q chunks;
    the kernel's grid already runs every q tile in parallel, so the
    flag changes nothing here.

    On DTensors (batch on ``data``, heads on ``model``) each rank runs
    the kernel on its block, its query heads over the KV heads they read
    (``kv_for_query_heads``).  Under sequence parallelism (the
    reference's ``seq`` rule: train, and ``--opt`` prefill where the
    heads do not split) each rank's queries attend over the whole
    sequence of keys: k and v are gathered along it and the rank's
    block of queries sits at its offset (``q_offset``); a sequence that
    does not split evenly (whisper's 1500 frames on 16) is gathered for
    the queries too.
    """
    if is_dtensor(q):
        q = _even_seq(q)
        dims = seq_dims(q)
        off = seq_blocks(q.device_mesh, dims, q.shape[1]).offset \
            if dims else 0
        k, v = kv_for_query_heads(q, whole_along(k, 1), whole_along(v, 1))
        return local_call(
            lambda a, b, c: flash_ops.flash_attention(
                a, b, c, causal=causal, window=window,
                q_offset=q_offset + off),
            tuple(q.placements), q, k, v)
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)


def _head_split(q):
    """(mesh dims that split q's heads (dim 2), this rank's index among
    them, their number of blocks)."""
    from torch.distributed.tensor import Shard
    mesh = q.device_mesh
    dims = [i for i, p in enumerate(q.placements)
            if isinstance(p, Shard) and p.dim % q.dim() == 2]
    coord, idx, n = mesh.get_coordinate(), 0, 1
    for i in dims:
        idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
    return dims, idx, n


def kv_for_query_heads(q, *kvs):
    """KV tensors (B, S, KV, ...) as DTensors whose local block on each
    rank holds the KV heads that the rank's query heads read, in order.
    Where the rules shard the KV heads as the query heads (or neither),
    they are returned as they are.  Where the query heads are split and
    the KV heads replicated (``sharding_rules_for`` drops ``kv_heads``
    when the model axis does not divide them, granite's one KV head), a
    rank holding query heads [h0, h0 + Hl) of groups of G = H / KV reads
    KV head h0 // G.  A rank's query heads must lie in one group (Hl
    divides G), as they do wherever the rules replicate the KV heads of
    an assigned config at a model axis of 2, 4 or 16; a group split
    across ranks raises."""
    from torch.distributed.tensor import Shard
    dims, idx, n = _head_split(q)
    pl0 = tuple(kvs[0].placements)
    same = [i for i, p in enumerate(pl0)
            if isinstance(p, Shard) and p.dim % kvs[0].dim() == 2]
    if same == dims:
        return kvs
    if same:
        raise NotImplementedError(
            "attention with the KV heads split otherwise than the query "
            "heads")
    H, KV = q.shape[2], kvs[0].shape[2]
    G, Hl = H // KV, H // n
    if G % Hl:
        raise NotImplementedError(
            f"{Hl} query heads a rank over groups of {G}: a group split "
            f"across ranks")
    first = idx * Hl // G
    out = []
    for t in kvs:
        pl = tuple(t.placements)
        want = tuple(Shard(2) if i in dims else p for i, p in enumerate(pl))
        out.append(local_call(
            lambda a: a[:, :, first:first + 1].contiguous(), want, t))
    return tuple(out)


# ---------------------------------------------------------------------------
# Decode attention (single query token vs. KV cache)
# ---------------------------------------------------------------------------

def _on_seq_blocks(q, kvs, rest, fn, dims):
    """``fn(blocks, q, *kvs, *rest)`` on each rank's local tensors, q
    replicated along the sequence-splitting mesh dims ``dims`` and the KV
    tensors ``kvs`` (the cache's k and v first, split on ``dims``) cut
    to the KV heads the rank's query heads read (``kv_for_query_heads``);
    its output placed as q was."""
    from torch.distributed.tensor import Replicate
    q_pl = tuple(q.placements)
    qr = redistribute(q, tuple(Replicate() if i in dims else p
                               for i, p in enumerate(q_pl)))
    kvs = kv_for_query_heads(qr, *kvs)
    blocks = seq_blocks(q.device_mesh, dims, kvs[0].shape[1])
    o = local_call(lambda *a: fn(blocks, *a), tuple(qr.placements), qr,
                   *kvs, *rest)
    return redistribute(o, q_pl)


def decode_attention(q, k_cache, v_cache, cur_len, *, window: int = 0,
                     span=None):
    """q: (B,1,H,D); caches: (B,S,KV,D); cur_len: (B,) valid cache
    entries *including* the new token already written.  Through the
    flash-decode kernel's wrapper, which keeps p in float32 as the
    reference's Pallas kernel does (its jnp path casts p to the cache's
    type first).  On DTensors each rank runs the kernel on its block, as
    ``chunked_attention``; over a cache split along its sequence axis,
    the block kernel (``decode_attention_block``) on each rank's rows,
    merged by log-sum-exp (``seq_blocks``).  ``span``: (start, w), the
    slice-reads window of global rows [start, start + w) on such a
    cache (``start`` a 0-d tensor, the same on every rank)."""
    if is_dtensor(q):
        dims = seq_dims(k_cache)
        if dims:
            def local(blocks, a, b, c, n):
                lo = None
                if span is not None:
                    start, w = span
                    first = n - window if window else torch.zeros_like(n)
                    lo = torch.maximum(first, start)
                    n = torch.minimum(n, start + w)
                o, lse = decode_ops.decode_attention_block(
                    a, b, c, n, window=0 if span is not None else window,
                    offset=blocks.offset, lo=lo)
                return blocks.combine(o, lse).to(a.dtype)
            return _on_seq_blocks(q, (k_cache, v_cache), (cur_len,),
                                  local, dims)
        if span is not None:
            raise ValueError("decode_attention: span is for a cache split "
                             "along its sequence axis")
        k_cache, v_cache = kv_for_query_heads(q, k_cache, v_cache)
        return local_call(
            lambda a, b, c, n: decode_ops.decode_attention(
                a, b, c, n, window=window),
            tuple(q.placements), q, k_cache, v_cache, cur_len)
    return decode_ops.decode_attention(q, k_cache, v_cache, cur_len,
                                       window=window)


def decode_attention_with_new(q, k_cache, v_cache, k_new, v_new, cur_len,
                              *, window: int = 0, span=None):
    """Decode attention over the cache as it was before this step's
    write, plus the new token out of band (the reference's in-place
    decode): q (B,1,H,D); caches (B,S,KV,D) with ``cur_len`` (B,) valid
    entries NOT counting the new token; k_new, v_new (B,1,KV,D).  With
    ``window`` the old entries >= cur_len - window + 1 stay, the new
    token sitting at position cur_len.  Plain torch (``_with_new``).  On
    DTensors each rank computes its block, as ``decode_attention``; over
    a cache split along its sequence axis each rank's part of the
    softmax, joined by all-reduces (``span``: the slice-reads window
    there, as ``decode_attention``'s)."""
    if is_dtensor(q):
        dims = seq_dims(k_cache)
        if dims:
            return _on_seq_blocks(
                q, (k_cache, v_cache, k_new, v_new), (cur_len,),
                lambda blocks, *a: _with_new(*a, window=window, span=span,
                                             blocks=blocks), dims)
        if span is not None:
            raise ValueError("decode_attention_with_new: span is for a "
                             "cache split along its sequence axis")
        k_cache, v_cache, k_new, v_new = kv_for_query_heads(
            q, k_cache, v_cache, k_new, v_new)
        return local_call(
            lambda a, b, c, d, e, n: _with_new(a, b, c, d, e, n,
                                               window=window),
            tuple(q.placements), q, k_cache, v_cache, k_new, v_new, cur_len)
    return _with_new(q, k_cache, v_cache, k_new, v_new, cur_len,
                     window=window)


def _no_reduce(t: torch.Tensor, op: str) -> torch.Tensor:
    return t


def _with_new(q, k_old, v_old, k_new, v_new, cur, *, window: int,
              span=None, blocks=None):
    """``decode_attention_with_new`` on local tensors: the old entries
    k_old, v_old are the whole cache (``blocks`` None) or this rank's
    block of it (global positions ``blocks.offset`` on, the other blocks
    on the ranks that ``blocks.reduce`` all-reduces over).

    The reference's arithmetic: float32 scores; the softmax's max and
    denominator over the old entries and the new one, the old entries'
    parts all-reduced before the new token's term enters, once; each
    old probability, normalised over all of them, cast to the cache's
    type before its PV product (the new token's k and v enter in their
    own type, unrounded); the products summed in float32, all-reduced,
    plus the new token's.  Output in q's type.  The whole cache is the
    one-block case of the same code, so a mesh dim of 1 gives the same
    bits.  With ``span`` (start, w) only the min(w, S) rows that can
    hold the window's part of the block are read."""
    B, _, H, D = q.shape
    S, KV = k_old.shape[1], k_old.shape[2]
    first, reduce = (0, _no_reduce) if blocks is None \
        else (blocks.offset, blocks.reduce)
    cur = torch.as_tensor(cur, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(B)
    if span is not None:
        start, w = span
        n = min(w, S)
        rows = torch.clamp(start - first, 0, S - n) \
            + torch.arange(n, device=q.device)
        k_old, v_old = k_old.index_select(1, rows), v_old.index_select(1, rows)
        pos = first + rows
    else:
        pos = first + torch.arange(S, device=q.device)
    scale = 1.0 / math.sqrt(D)
    qr = q.reshape(B, KV, H // KV, D).float()
    s_old = torch.einsum("bhgd,bshd->bhgs", qr, k_old.float()) * scale
    valid = pos[None] < cur[:, None]
    if window:
        valid &= pos[None] >= (cur[:, None] - window + 1)
    if span is not None:
        valid &= (pos[None] >= start) & (pos[None] < start + w)
    s_old = s_old.masked_fill(~valid[:, None, None, :], NEG_INF)
    s_new = torch.einsum("bhgd,bohd->bhgo", qr, k_new.float()) * scale
    m = torch.maximum(reduce(s_old.amax(-1, keepdim=True), "max"), s_new)
    e_old, e_new = torch.exp(s_old - m), torch.exp(s_new - m)
    den = reduce(e_old.sum(-1, keepdim=True), "sum") + e_new
    p_old = (e_old / den).to(v_old.dtype).float()
    p_new = (e_new / den).to(v_new.dtype).float()
    o = reduce(torch.einsum("bhgs,bshd->bhgd", p_old, v_old.float()), "sum") \
        + torch.einsum("bhgo,bohd->bhgd", p_new, v_new.float())
    return o.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def embed_schema(cfg):
    s = {"tok": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                  init="embed")}
    if not cfg.tie_embeddings:
        s["head"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return s


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(p["tok"]):
        # DTensor's vocab-parallel lookup, the embed axis gathered first
        # (fsdp shards it on data, as the tokens' batch).  Under grad the
        # vocab axis is gathered too: the vocab-parallel lookup leaves a
        # masked Partial output, whose backward cannot take the Partial
        # gradient that a row-split product upstream (the Mamba2, mLSTM
        # and attention out projections) sends it
        tab = whole_along(p["tok"], 1)
        if torch.is_grad_enabled() and tab.requires_grad:
            tab = whole_along(tab, 0)
        return F.embedding(tokens, tab)
    return p["tok"][tokens]


def unembed(cfg, p, x: torch.Tensor) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = x @ w
    # With Megatron-style sequence-parallel activations ("seq" mapped to the
    # model axis) the logits stay seq-sharded; otherwise shard the vocab dim
    # (both would collide on the model axis).
    if rule_active("seq"):
        return constrain(logits, ("batch", "seq", None))
    return constrain(logits, ("batch", "seq", "vocab"))
