"""DDPM++-style U-Net for CIFAR-scale image diffusion, in PyTorch.

The port of ``repro.diffusion.unet``.  Per-sample timestep conditioning
lets one batched forward mix denoising tasks of different services at
different step indices, which is what STACKING's batches are.

Layout: the public functions take and return NHWC tensors, as the
reference does.  Inside, activations stay NHWC-contiguous:
``x.permute(0, 3, 1, 2)`` is an NCHW view in channels_last memory, which
``F.conv2d`` takes natively, and the GroupNorm+SiLU kernel reads the
NHWC tensor with no copy.  Params are a plain nested dict of tensors
(``schema`` below), convolution weights OIHW.

The matrix products (time embedding, attention) run at
``product_rows(B)`` rows, the power-of-two bucket of the batch, with
zero rows added where B is short of it.  cuBLAS picks its kernel, and
so the order of each row's sums, by the row count; at the bucket a row
gets the same products in a batch of B as in the bucketed engine's
padded batch (``diffusion/bucketed.py``).  cuDNN does the same for a
few convolution shapes, and those alone run at the bucket too
(``conv_rows``).  The group norms give a row the same result at either
width.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.ddim_cifar10 import UNetConfig
from repro_torch.core.execution import shape_bucket
from repro_torch.kernels.groupnorm_silu import ops as gn_ops
from repro_torch.kernels.groupnorm_silu.ref import group_norm_ref
from repro_torch.models.params import P


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _same_pads(size: int, k: int, stride: int):
    """(low, high) padding of XLA's "SAME": the output has
    ceil(size / stride) positions and the odd pad goes high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int):
    xn = x.permute(0, 3, 1, 2)
    (ph0, ph1) = _same_pads(x.shape[1], w.shape[2], stride)
    (pw0, pw1) = _same_pads(x.shape[2], w.shape[3], stride)
    if ph0 == ph1 and pw0 == pw1:
        out = F.conv2d(xn, w, stride=stride, padding=(ph0, pw0))
    else:
        out = F.conv2d(F.pad(xn, (pw0, pw1, ph0, ph1)), w, stride=stride)
    return out.permute(0, 2, 3, 1).contiguous()


# (x shape, w shape, stride, device) of a convolution on the card -> the
# rows it runs at (conv_rows)
_conv_rows_seen: dict = {}


def conv_rows(x, w, stride: int) -> int:
    """Rows a convolution of the batch x runs at: B, or on the card
    ``product_rows(B)`` where cuDNN gives a row another result at B
    than at that width (it picks its algorithm by the batch size).
    Found at the first call of each shape by running both."""
    B, Bp = x.shape[0], product_rows(x.shape[0])
    if Bp == B or not x.is_cuda:
        return B
    key = (tuple(x.shape), tuple(w.shape), stride, x.device)
    if key not in _conv_rows_seen:
        same = torch.equal(_conv(x, w, stride),
                           _conv(pad_rows(x, Bp), w, stride)[:B])
        _conv_rows_seen[key] = B if same else Bp
    return _conv_rows_seen[key]


def conv2d(x, w, b=None, stride: int = 1):
    """x: (B, H, W, Cin) NHWC; w: (Cout, Cin, kh, kw).  "SAME" padding
    as in the reference: for k=3, s=2 on an even input that pads (0, 1),
    which ``padding=1`` would get wrong.  Runs at ``conv_rows`` rows."""
    B = x.shape[0]
    out = _conv(pad_rows(x, conv_rows(x, w, stride)), w, stride)[:B]
    if b is not None:
        out = out + b
    return out


def group_norm(x, scale, bias, num_groups: int, eps: float = 1e-6):
    return group_norm_ref(x, scale, bias, num_groups, eps).to(x.dtype)


def gn_silu(x, scale, bias, num_groups: int):
    """Fused GroupNorm+SiLU: the CUDA kernel for a tensor on the card,
    its plain version on the CPU (``kernels/groupnorm_silu/ops.py``)."""
    return gn_ops.groupnorm_silu(x, scale, bias, num_groups)


def product_rows(B: int) -> int:
    """Rows the matrix products run at for a batch of B."""
    return shape_bucket(B)


def pad_rows(x, rows: int, value: float = 0.0):
    """x with rows of ``value`` added along dim 0 up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, rows - x.shape[0]),
                 value=value)


def timestep_embedding(t, dim: int, max_period: float = 10000.0):
    """t: (B,) float timesteps -> (B, dim) sinusoidal embedding,
    ``[cos, sin]`` in that order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def upsample2x(x):
    """Nearest-neighbour 2x upsampling of NHWC (the reference's
    ``jax.image.resize(..., "nearest")`` at exactly 2x)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def _conv_p(kh, kw, cin, cout, scale=None):
    return P((cout, cin, kh, kw), (None,) * 4, scale=scale, conv=True)


def _res_block_schema(cin, cout, temb_dim):
    return {
        "gn1_s": P((cin,), (None,), init="ones"),
        "gn1_b": P((cin,), (None,), init="zeros"),
        "conv1": _conv_p(3, 3, cin, cout),
        "temb": P((temb_dim, cout), (None, None)),
        "gn2_s": P((cout,), (None,), init="ones"),
        "gn2_b": P((cout,), (None,), init="zeros"),
        "conv2": _conv_p(3, 3, cout, cout, scale=0.05),
        **({"skip": _conv_p(1, 1, cin, cout)} if cin != cout else {}),
    }


def _attn_schema(ch):
    return {
        "gn_s": P((ch,), (None,), init="ones"),
        "gn_b": P((ch,), (None,), init="zeros"),
        "wq": P((ch, ch), (None, None)),
        "wk": P((ch, ch), (None, None)),
        "wv": P((ch, ch), (None, None)),
        "wo": P((ch, ch), (None, None), scale=0.05),
    }


def schema(cfg: UNetConfig):
    ch = cfg.base_channels
    temb = 4 * ch
    s = {
        "temb1": P((ch, temb), (None, None)),
        "temb2": P((temb, temb), (None, None)),
        "conv_in": _conv_p(3, 3, cfg.in_channels, ch),
        "gn_out_s": P((ch,), (None,), init="ones"),
        "gn_out_b": P((ch,), (None,), init="zeros"),
        "conv_out": _conv_p(3, 3, ch, cfg.in_channels, scale=1e-10),
    }
    res = cfg.image_size
    cin = ch
    downs, chans = [], [(cin, res)]
    for li, mult in enumerate(cfg.channel_mults):
        cout = ch * mult
        level = {"res": []}
        for _ in range(cfg.num_res_blocks):
            blk = {"res": _res_block_schema(cin, cout, temb)}
            if res in cfg.attn_resolutions:
                blk["attn"] = _attn_schema(cout)
            level["res"].append(blk)
            cin = cout
            chans.append((cin, res))
        if li != len(cfg.channel_mults) - 1:
            level["down"] = _conv_p(3, 3, cin, cin)
            res //= 2
            chans.append((cin, res))
        downs.append(level)
    s["downs"] = downs
    s["mid1"] = _res_block_schema(cin, cin, temb)
    s["mid_attn"] = _attn_schema(cin)
    s["mid2"] = _res_block_schema(cin, cin, temb)

    ups = []
    for li, mult in reversed(list(enumerate(cfg.channel_mults))):
        cout = ch * mult
        level = {"res": []}
        for _ in range(cfg.num_res_blocks + 1):
            skip_c, skip_res = chans.pop()
            blk = {"res": _res_block_schema(cin + skip_c, cout, temb)}
            if skip_res in cfg.attn_resolutions:
                blk["attn"] = _attn_schema(cout)
            level["res"].append(blk)
            cin = cout
        if li != 0:
            level["up"] = _conv_p(3, 3, cin, cin)
            res *= 2
        ups.append(level)
    s["ups"] = ups
    return s


def gn_silu_calls(cfg: UNetConfig) -> int:
    """``gn_silu`` calls in one forward, read off the schema: two per
    residual block, one for the output head (45 at ``CONFIG``)."""
    s = schema(cfg)
    blocks = sum(len(level["res"]) for level in s["downs"] + s["ups"])
    return 2 * (blocks + 2) + 1               # + mid1, mid2; + head


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _res_block(cfg, p, x, temb):
    h = gn_silu(x, p["gn1_s"], p["gn1_b"], cfg.num_groups)
    h = conv2d(h, p["conv1"])
    h = h + (F.silu(temb) @ p["temb"])[:h.shape[0], None, None, :]
    h = gn_silu(h, p["gn2_s"], p["gn2_b"], cfg.num_groups)
    h = conv2d(h, p["conv2"])
    skip = conv2d(x, p["skip"]) if "skip" in p else x
    return skip + h


def _attn_block(cfg, p, x):
    B, H, W, C = x.shape
    h = group_norm(x, p["gn_s"], p["gn_b"], cfg.num_groups)
    flat = pad_rows(h.reshape(B, H * W, C), product_rows(B))
    q, k, v = flat @ p["wq"], flat @ p["wk"], flat @ p["wv"]
    attn = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(C), dim=-1)
    out = (attn @ v) @ p["wo"]
    return x + out[:B].reshape(B, H, W, C)


def forward(cfg: UNetConfig, params, x, t):
    """x: (B, H, W, C) noisy images; t: (B,) per-sample timesteps.
    Returns predicted noise eps, same shape as x.  The time embedding
    runs at ``product_rows(B)`` rows (added rows at t = -1)."""
    t = pad_rows(t, product_rows(x.shape[0]), -1.0)
    temb = timestep_embedding(t, cfg.base_channels)
    temb = F.silu(temb @ params["temb1"]) @ params["temb2"]

    h = conv2d(x, params["conv_in"])
    skips = [h]
    for level in params["downs"]:
        for blk in level["res"]:
            h = _res_block(cfg, blk["res"], h, temb)
            if "attn" in blk:
                h = _attn_block(cfg, blk["attn"], h)
            skips.append(h)
        if "down" in level:
            h = conv2d(h, level["down"], stride=2)
            skips.append(h)

    h = _res_block(cfg, params["mid1"], h, temb)
    h = _attn_block(cfg, params["mid_attn"], h)
    h = _res_block(cfg, params["mid2"], h, temb)

    for level in params["ups"]:
        for blk in level["res"]:
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _res_block(cfg, blk["res"], h, temb)
            if "attn" in blk:
                h = _attn_block(cfg, blk["attn"], h)
        if "up" in level:
            h = conv2d(upsample2x(h), level["up"])

    h = gn_silu(h, params["gn_out_s"], params["gn_out_b"], cfg.num_groups)
    return conv2d(h, params["conv_out"])
