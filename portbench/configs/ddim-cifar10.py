"""Plain reference of ``ddim-cifar10``: the DDPM CIFAR-10 U-Net
[arXiv:2006.11239] and the deterministic DDIM update [arXiv:2010.02502]
in plain PyTorch, float32, with no kernel, batching or cache of the
program's; and the benchmark's weights for it.

``make_weights(cfg, seed, device)`` draws every weight on the device
from the seed in one call (normal(0, 1/sqrt(fan_in)) for products and
convolutions, the norms' scales 1 and biases 0), laid out as the port
takes them: a nested dict, convolutions OIHW, products (in, out).  The
benchmark hands the same tensors' values to the program and, drawn
again after the program is freed, to this reference.

``denoise(cfg, w, x, schedules)`` runs each image's own (t_now,
t_next) steps from its start latent x (N, H, W, C) and returns the
final images.  It sets nothing: the caller chooses the precision
(``torch.backends`` flags; TF32 off is the configuration's).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Layout and weights
# ---------------------------------------------------------------------------

def _conv(cin, cout, k):
    return ("normal", (cout, cin, k, k), 1.0 / math.sqrt(cin * k * k))


def _dense(n_in, n_out):
    return ("normal", (n_in, n_out), 1.0 / math.sqrt(n_in))


def _norm(c):
    return ("ones", (c,), 0.0), ("zeros", (c,), 0.0)


def _res(cin, cout, temb):
    g1s, g1b = _norm(cin)
    g2s, g2b = _norm(cout)
    d = {"gn1_s": g1s, "gn1_b": g1b, "conv1": _conv(cin, cout, 3),
         "temb": _dense(temb, cout), "gn2_s": g2s, "gn2_b": g2b,
         "conv2": _conv(cout, cout, 3)}
    if cin != cout:
        d["skip"] = _conv(cin, cout, 1)
    return d


def _attn(c):
    s, b = _norm(c)
    return {"gn_s": s, "gn_b": b, "wq": _dense(c, c), "wk": _dense(c, c),
            "wv": _dense(c, c), "wo": _dense(c, c)}


def layout(cfg: dict):
    ch = cfg["base_channels"]
    temb = 4 * ch
    s, e = _norm(ch)
    lay = {"temb1": _dense(ch, temb), "temb2": _dense(temb, temb),
           "conv_in": _conv(cfg["in_channels"], ch, 3),
           "gn_out_s": s, "gn_out_b": e,
           "conv_out": _conv(ch, cfg["in_channels"], 3)}
    res, cin = cfg["image_size"], ch
    chans, downs = [(cin, res)], []
    mults = cfg["channel_mults"]
    for li, m in enumerate(mults):
        cout = ch * m
        level = {"res": []}
        for _ in range(cfg["num_res_blocks"]):
            blk = {"res": _res(cin, cout, temb)}
            if res in cfg["attn_resolutions"]:
                blk["attn"] = _attn(cout)
            level["res"].append(blk)
            cin = cout
            chans.append((cin, res))
        if li != len(mults) - 1:
            level["down"] = _conv(cin, cin, 3)
            res //= 2
            chans.append((cin, res))
        downs.append(level)
    lay["downs"] = downs
    lay["mid1"] = _res(cin, cin, temb)
    lay["mid_attn"] = _attn(cin)
    lay["mid2"] = _res(cin, cin, temb)
    ups = []
    for li, m in reversed(list(enumerate(mults))):
        cout = ch * m
        level = {"res": []}
        for _ in range(cfg["num_res_blocks"] + 1):
            skip_c, skip_res = chans.pop()
            blk = {"res": _res(cin + skip_c, cout, temb)}
            if skip_res in cfg["attn_resolutions"]:
                blk["attn"] = _attn(cout)
            level["res"].append(blk)
            cin = cout
        if li != 0:
            level["up"] = _conv(cin, cin, 3)
            res *= 2
        ups.append(level)
    lay["ups"] = ups
    return lay


def _leaves(tree, out):
    if isinstance(tree, dict):
        for k in tree:
            _leaves(tree[k], out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    else:
        out.append(tree)
    return out


def make_weights(cfg: dict, seed: int, device) -> dict:
    lay = layout(cfg)
    total = sum(int(np.prod(shp)) for kind, shp, _ in _leaves(lay, [])
                if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    pos = [0]

    def build(t):
        if isinstance(t, dict):
            return {k: build(v) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v) for v in t]
        kind, shp, std = t
        if kind == "ones":
            return torch.ones(shp, dtype=torch.float32, device=device)
        if kind == "zeros":
            return torch.zeros(shp, dtype=torch.float32, device=device)
        n = int(np.prod(shp))
        w = flat[pos[0]:pos[0] + n].view(shp).mul_(std)
        pos[0] += n
        return w

    weights = build(lay)
    del build      # its closure holds itself and ``flat``: a cycle
    return weights


# ---------------------------------------------------------------------------
# U-Net, NCHW inside
# ---------------------------------------------------------------------------

def conv(x, w, stride=1):
    """'SAME' padding: ceil(size / stride) outputs, the odd pad high."""
    k = w.shape[-1]
    size = x.shape[-1]
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    lo, hi = total // 2, total - total // 2
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, stride=stride)


def gnorm(x, s, b, groups):
    return F.group_norm(x, groups, s, b, eps=1e-6)


def res_block(p, x, temb, groups):
    h = conv(F.silu(gnorm(x, p["gn1_s"], p["gn1_b"], groups)), p["conv1"])
    h = h + (F.silu(temb) @ p["temb"])[:, :, None, None]
    h = conv(F.silu(gnorm(h, p["gn2_s"], p["gn2_b"], groups)), p["conv2"])
    return (conv(x, p["skip"]) if "skip" in p else x) + h


def attn_block(p, x, groups):
    B, C, H, W = x.shape
    h = gnorm(x, p["gn_s"], p["gn_b"], groups)
    flat = h.reshape(B, C, H * W).transpose(1, 2)
    q, k, v = flat @ p["wq"], flat @ p["wk"], flat @ p["wv"]
    a = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), dim=-1)
    out = (a @ v) @ p["wo"]
    return x + out.transpose(1, 2).reshape(B, C, H, W)


def eps(cfg: dict, w: dict, x_nhwc, t):
    """Predicted noise of x (B, H, W, C) at per-image timesteps t (B,)."""
    groups = cfg["num_groups"]
    ch = cfg["base_channels"]
    half = ch // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=x_nhwc.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    temb = F.silu(emb @ w["temb1"]) @ w["temb2"]
    h = conv(x_nhwc.permute(0, 3, 1, 2), w["conv_in"])
    skips = [h]
    for level in w["downs"]:
        for blk in level["res"]:
            h = res_block(blk["res"], h, temb, groups)
            if "attn" in blk:
                h = attn_block(blk["attn"], h, groups)
            skips.append(h)
        if "down" in level:
            h = conv(h, level["down"], stride=2)
            skips.append(h)
    h = res_block(w["mid1"], h, temb, groups)
    h = attn_block(w["mid_attn"], h, groups)
    h = res_block(w["mid2"], h, temb, groups)
    for level in w["ups"]:
        for blk in level["res"]:
            h = res_block(blk["res"], torch.cat([h, skips.pop()], dim=1),
                          temb, groups)
            if "attn" in blk:
                h = attn_block(blk["attn"], h, groups)
        if "up" in level:
            h = conv(F.interpolate(h, scale_factor=2, mode="nearest"),
                     level["up"])
    h = F.silu(gnorm(h, w["gn_out_s"], w["gn_out_b"], groups))
    return conv(h, w["conv_out"]).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# DDIM
# ---------------------------------------------------------------------------

def denoise(cfg: dict, w: dict, x, schedules: List[List[Tuple[int, int]]]):
    """Each image i advanced by its own steps ``schedules[i]`` (t_now,
    t_next; t_next = -1 ends at alpha_bar = 1), all images in one batch
    per step index; an image out of steps passes through."""
    betas = np.linspace(cfg["beta_start"], cfg["beta_end"],
                        cfg["num_train_timesteps"], dtype=np.float64)
    acp = torch.as_tensor(np.cumprod(1.0 - betas), dtype=torch.float32,
                          device=x.device)
    x = x.clone()
    n = max((len(s) for s in schedules), default=0)
    for j in range(n):
        rows = [i for i, s in enumerate(schedules) if j < len(s)]
        tn = torch.tensor([schedules[i][j][0] for i in rows],
                          device=x.device)
        tx = torch.tensor([schedules[i][j][1] for i in rows],
                          device=x.device)
        xs = x[rows]
        e = eps(cfg, w, xs, tn)
        a_now = acp[tn].view(-1, 1, 1, 1)
        a_next = torch.where(tx < 0, torch.ones_like(acp[tn]),
                             acp[tx.clamp(min=0)]).view(-1, 1, 1, 1)
        x0 = (xs - torch.sqrt(1.0 - a_now) * e) / torch.sqrt(a_now)
        x[rows] = torch.sqrt(a_next) * x0 + torch.sqrt(1.0 - a_next) * e
    return x
