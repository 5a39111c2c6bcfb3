"""Frozen copy of ``groupnorm_silu``'s cost: one call reads x, scale and
bias once and writes y once, and does 12 float32 operations an element
of x (mean 1, variance 3, normalize 4, SiLU 4), at the float32 rate.
And the calls one U-Net forward makes: two per residual block (its
two norms, on its input and its output width), one for the head."""

from __future__ import annotations

from typing import List, Tuple

import peaks

OPS_PER_ELEMENT = 12


def cost(B: int, H: int, W: int, C: int, itemsize: int = 4):
    """(operations, bytes) of one call on x (B, H, W, C)."""
    n = B * H * W * C
    return OPS_PER_ELEMENT * n, 2 * n * itemsize + 2 * C * 4


def bound_s(B: int, H: int, W: int, C: int, itemsize: int = 4) -> float:
    ops, nbytes = cost(B, H, W, C, itemsize)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_OPS_PER_S)


def unet_calls(cfg: dict) -> List[Tuple[int, int, int]]:
    """(H, W, C) of each call of one forward, in order."""
    ch, res = cfg["base_channels"], cfg["image_size"]
    mults, nrb = cfg["channel_mults"], cfg["num_res_blocks"]
    calls, cin, chans = [], ch, [(ch, res)]
    for li, m in enumerate(mults):
        cout = ch * m
        for _ in range(nrb):
            calls += [(res, res, cin), (res, res, cout)]
            cin = cout
            chans.append((cin, res))
        if li != len(mults) - 1:
            res //= 2
            chans.append((cin, res))
    calls += [(res, res, cin)] * 4                  # mid1, mid2
    for li, m in reversed(list(enumerate(mults))):
        cout = ch * m
        for _ in range(nrb + 1):
            skip_c, _ = chans.pop()
            calls += [(res, res, cin + skip_c), (res, res, cout)]
            cin = cout
        if li != 0:
            res *= 2
    calls.append((res, res, cin))                   # the head
    return calls


def forward_bound_s(cfg: dict, B: int) -> float:
    """The least time the card could take for one forward's calls on a
    batch of B images."""
    return sum(bound_s(B, h, w, c) for h, w, c in unet_calls(cfg))
