"""Plain reference of ``deepseek-moe-16b`` [arXiv:2401.06066] as the
configuration runs it: a decoder of RMSNorm, rotary multi-head
attention and a DeepSeekMoE layer (softmax router, top-6 of 64 routed
experts with the gates renormalised, 2 shared experts, SwiGLU) in every
layer, in plain PyTorch and float32, with no kernel, cache or batching
of the program's; and the benchmark's weights and prompts for it.

The configuration serves each request as a prefill of its prompt
followed by one decode step a token over a bfloat16 KV cache, the
first step re-feeding the prompt's last token at position S.  The
reference computes all of a request's positions in one pass and keeps
what that serving changes in the mathematics:

  * a prompt position attends over the prompt's float32 k and v; a
    decode position over every earlier position's k and v rounded to
    bfloat16 (the cache's type), its own included;
  * the router's capacity (``capacity_factor``) applies within a group:
    the prompt's tokens form one group (each expert takes at most
    C = max(1, int(S K cf / E)) of its choices, earlier tokens first;
    a dropped choice adds nothing), and each decode token is a group
    of its own.

``make_weights(cfg, seed, device)`` draws every weight on the device
from the seed, normal(0, ``initializer_range``), in a few large calls,
norms at 1, laid out as the port takes them (``embed``, ``final_norm``,
``layers`` stacked on a leading layer axis).  It sets no precision
flag: the caller chooses (TF32 off is the configuration's).
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

CHUNK = 1 << 30          # elements a draw call fills


def dims(cfg: dict):
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    return dict(d=d, L=cfg["num_hidden_layers"], H=H,
                KV=cfg["num_key_value_heads"], hd=d // H,
                V=cfg["vocab_size"], E=cfg["n_routed_experts"],
                K=cfg["num_experts_per_tok"],
                f=cfg["moe_intermediate_size"],
                fs=cfg["moe_intermediate_size"] * cfg["n_shared_experts"])


def layout(cfg: dict):
    z = dims(cfg)
    d, L, H, KV, hd, V, E, f, fs = (z[k] for k in
                                    "d L H KV hd V E f fs".split())
    n = "normal"
    return {
        "embed": {"tok": (n, (V, d)), "head": (n, (d, V))},
        "final_norm": {"scale": ("ones", (d,))},
        "layers": {
            "ln1": {"scale": ("ones", (L, d))},
            "attn": {"wq": (n, (L, d, H, hd)), "wk": (n, (L, d, KV, hd)),
                     "wv": (n, (L, d, KV, hd)), "wo": (n, (L, H, hd, d))},
            "ln2": {"scale": ("ones", (L, d))},
            "moe": {"router": (n, (L, d, E)), "up": (n, (L, E, d, f)),
                    "gate": (n, (L, E, d, f)), "down": (n, (L, E, f, d)),
                    "shared_up": (n, (L, d, fs)),
                    "shared_gate": (n, (L, d, fs)),
                    "shared_down": (n, (L, fs, d))}}}


def make_weights(cfg: dict, seed: int, device) -> dict:
    lay = layout(cfg)
    std = float(cfg["initializer_range"])
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(lay)
    total = sum(int(np.prod(s)) for kind, s in leaves if kind == "normal")
    flat = torch.empty(total, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    for lo in range(0, total, CHUNK):
        flat[lo:lo + CHUNK].normal_(0.0, std, generator=gen)
    pos = [0]

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        kind, shp = t
        if kind == "ones":
            return torch.ones(shp, dtype=torch.float32, device=device)
        m = int(np.prod(shp))
        w = flat[pos[0]:pos[0] + m].view(shp)
        pos[0] += m
        return w
    weights = build(lay)
    del build      # its closure holds itself and ``flat``: a cycle
    return weights


def prompt(prompt_seed: int, request_id: int, vocab: int, n: int):
    """A request's prompt: n token ids uniform in the vocabulary from
    the generator seeded prompt_seed * 7919 + its id."""
    rng = np.random.default_rng(prompt_seed * 7919 + request_id)
    return rng.integers(0, vocab, n).astype(np.int32)


def rmsnorm(x, scale, eps: float):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta: float):
    """x (T, H, D) rotated by position pos (T,): the two halves of each
    head, [x1 cos - x2 sin, x2 cos + x1 sin]."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32,
                                          device=x.device) / D))
    ang = pos.float()[:, None] * freqs                   # (T, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, causal_from: int):
    """q (Tq, H, D) at positions causal_from .. causal_from + Tq - 1
    over k, v (Tk, H, D) at 0 .. Tk - 1, causal."""
    D = q.shape[-1]
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(D)
    qp = torch.arange(q.shape[0], device=q.device)[:, None] + causal_from
    kp = torch.arange(k.shape[0], device=q.device)[None]
    s = s.masked_fill(kp > qp, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


def _route(h, router, K: int, E: int, groups, cf: float):
    """(expert ids (T, K), gates (T, K) with dropped choices at 0)."""
    probs = torch.softmax(h @ router, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :K], ids[:, :K]
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.ones_like(gates, dtype=torch.bool)
    for lo, n in groups:
        C = max(1, int(n * K * cf / E))
        flat = ids[lo:lo + n].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, E)
        pos = (onehot.cumsum(0) - 1).gather(1, flat[:, None])[:, 0]
        keep[lo:lo + n] = (pos < C).reshape(n, K)
    return ids, torch.where(keep, gates, torch.zeros_like(gates))


def decode_logits(cfg: dict, w: dict, seqs: List[torch.Tensor],
                  prompt_len: int, routes: Optional[list] = None
                  ) -> List[torch.Tensor]:
    """Per request, the logits (n, V) at its decode positions
    prompt_len .. len - 1, where ``seqs[i]`` is its prompt followed by
    the tokens fed to its decode steps (the prompt's last token, then
    each served token but the last).  ``routes``, where given, gets
    each layer's routed expert ids (T, K) over the concatenated
    sequences, on the host."""
    z = dims(cfg)
    L, H, KV, hd, E, K = (z[k] for k in "L H KV hd E K".split())
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    cf = cfg["capacity_factor"]
    dev = w["embed"]["tok"].device
    P = prompt_len
    lens = [len(s) for s in seqs]
    starts = np.cumsum([0] + lens[:-1]).tolist()
    toks = torch.cat([s.to(dev).long() for s in seqs])
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    groups = []
    for lo, n in zip(starts, lens):
        groups.append((lo, P))
        groups += [(lo + p, 1) for p in range(P, n)]
    x = w["embed"]["tok"][toks]
    lw = w["layers"]
    for li in range(L):
        h = rmsnorm(x, lw["ln1"]["scale"][li], eps)
        a = lw["attn"]
        q = rope((h @ a["wq"][li].flatten(1)).view(-1, H, hd), pos, theta)
        k = rope((h @ a["wk"][li].flatten(1)).view(-1, KV, hd), pos, theta)
        v = (h @ a["wv"][li].flatten(1)).view(-1, KV, hd)
        o = torch.empty_like(q)
        for lo, n in zip(starts, lens):
            kk, vv = k[lo:lo + n], v[lo:lo + n]
            if H != KV:
                kk = kk.repeat_interleave(H // KV, dim=1)
                vv = vv.repeat_interleave(H // KV, dim=1)
            o[lo:lo + P] = _attend(q[lo:lo + P], kk[:P], vv[:P], 0)
            if n > P:
                kb = kk.to(torch.bfloat16).float()
                vb = vv.to(torch.bfloat16).float()
                o[lo + P:lo + n] = _attend(q[lo + P:lo + n], kb, vb, P)
        x = x + o.flatten(1) @ a["wo"][li].flatten(0, 1)
        h = rmsnorm(x, lw["ln2"]["scale"][li], eps)
        m = lw["moe"]
        ids, gates = _route(h, m["router"][li], K, E, groups, cf)
        if routes is not None:
            routes.append(ids.cpu().numpy())
        part = torch.zeros(h.shape[0], K, h.shape[1], device=dev)
        for e in range(E):
            t_idx, k_idx = torch.nonzero(ids == e, as_tuple=True)
            if t_idx.numel() == 0:
                continue
            he = h[t_idx]
            y = (he @ m["up"][li, e]) * torch.nn.functional.silu(
                he @ m["gate"][li, e])
            part[t_idx, k_idx] = (y @ m["down"][li, e]) \
                * gates[t_idx, k_idx][:, None]
        out = part[:, 0]
        for j in range(1, K):
            out = out + part[:, j]
        sh = (h @ m["shared_up"][li]) * torch.nn.functional.silu(
            h @ m["shared_gate"][li])
        x = x + out + sh @ m["shared_down"][li]
    sel = torch.cat([torch.arange(lo + P, lo + n, device=dev)
                     for lo, n in zip(starts, lens)])
    logits = rmsnorm(x[sel], w["final_norm"]["scale"], eps) \
        @ w["embed"]["head"]
    return list(torch.split(logits, [n - P for n in lens]))
