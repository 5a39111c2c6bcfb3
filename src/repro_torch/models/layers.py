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
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.models.params import (P, constrain, is_dtensor,
                                       local_call, rule_active, whole_along)

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
        return local_call(lambda a, c, s: apply_rope(a, None, theta, (c, s)),
                          tuple(x.placements), x, cos, sin)
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], dim=-1) * sin).to(x.dtype)


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
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


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
    """einsum("bshk,hkd->bsd")."""
    h, k, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], h * k) @ p["wo"].reshape(h * k, d)


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
    (``kv_for_query_heads``).
    """
    if is_dtensor(q):
        k, v = kv_for_query_heads(q, k, v)
        return local_call(
            lambda a, b, c: flash_ops.flash_attention(
                a, b, c, causal=causal, window=window, q_offset=q_offset),
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

def decode_attention(q, k_cache, v_cache, cur_len, *, window: int = 0):
    """q: (B,1,H,D); caches: (B,S,KV,D); cur_len: (B,) valid cache
    entries *including* the new token already written.  Through the
    flash-decode kernel's wrapper, which keeps p in float32 as the
    reference's Pallas kernel does (its jnp path casts p to the cache's
    type first).  On DTensors each rank runs the kernel on its block, as
    ``chunked_attention``."""
    if is_dtensor(q):
        k_cache, v_cache = kv_for_query_heads(q, k_cache, v_cache)
        return local_call(
            lambda a, b, c, n: decode_ops.decode_attention(
                a, b, c, n, window=window),
            tuple(q.placements), q, k_cache, v_cache, cur_len)
    return decode_ops.decode_attention(q, k_cache, v_cache, cur_len,
                                       window=window)


def decode_attention_with_new(q, k_cache, v_cache, k_new, v_new, cur_len,
                              *, window: int = 0):
    """Decode attention over the cache as it was before this step's
    write, plus the new token out of band (the reference's in-place
    decode): q (B,1,H,D); caches (B,S,KV,D) with ``cur_len`` (B,) valid
    entries NOT counting the new token; k_new, v_new (B,1,KV,D).  With
    ``window`` the old entries >= cur_len - window + 1 stay, the new
    token sitting at position cur_len.

    The reference's arithmetic, in plain torch: float32 scores and
    softmax over the S old positions and the new one; the old entries'
    probabilities cast to the cache's type before their PV product (the
    new token's k and v enter in their own type, unrounded), products
    summed in float32.  Output in q's type.  On DTensors each rank
    computes its block, as ``decode_attention``."""
    if is_dtensor(q):
        k_cache, v_cache, k_new, v_new = kv_for_query_heads(
            q, k_cache, v_cache, k_new, v_new)
        return local_call(
            lambda a, b, c, d, e, n: decode_attention_with_new(
                a, b, c, d, e, n, window=window),
            tuple(q.placements), q, k_cache, v_cache, k_new, v_new, cur_len)
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    scale = 1.0 / math.sqrt(D)
    cur = torch.as_tensor(cur_len, device=q.device)
    if cur.dim() == 0:
        cur = cur.expand(B)
    qr = q.reshape(B, KV, H // KV, D).float()
    s_old = torch.einsum("bhgd,bshd->bhgs", qr, k_cache.float()) * scale
    pos = torch.arange(S, device=q.device)
    valid = pos[None] < cur[:, None]
    if window:
        valid &= pos[None] >= (cur[:, None] - window + 1)
    s_old = s_old.masked_fill(~valid[:, None, None, :], NEG_INF)
    s_new = torch.einsum("bhgd,bohd->bhgo", qr, k_new.float()) * scale
    p = torch.softmax(torch.cat([s_old, s_new], dim=-1), dim=-1)
    p_old = p[..., :S].to(v_cache.dtype).float()
    p_new = p[..., S:].to(v_new.dtype).float()
    o = torch.einsum("bhgs,bshd->bhgd", p_old, v_cache.float()) \
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
