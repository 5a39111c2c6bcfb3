"""Frozen copy of ``decode_attention``'s cost: one call reads q and
writes o once (float32), reads the (B,) int32 valid lengths, and of the
cache's k and v the rows it attends over, sum over rows of
min(cur_len, S); 4 D operations per such row and query head, at the
float32 rate on the CUDA-core path (a group of G <= 8 heads with
G * D < 1024), at 3 bfloat16 products each on the tensor-core path."""

from __future__ import annotations

from typing import Sequence

import peaks

TC_MIN_WORK = 1024


def cost(cur_lens: Sequence[int], S: int, H: int, KV: int, D: int,
         cache_itemsize: int = 2, q_itemsize: int = 4):
    """(operations, bytes, operations per second) of one call over the
    rows' valid lengths ``cur_lens``."""
    B = len(cur_lens)
    valid = sum(min(int(c), S) for c in cur_lens)
    ops = 4 * D * H * valid
    nbytes = 2 * B * H * D * q_itemsize + 4 * B \
        + 2 * valid * KV * D * cache_itemsize
    G = H // KV
    if G > 8 or G * D >= TC_MIN_WORK:
        rate = peaks.BF16_OPS_PER_S / 3
    else:
        rate = peaks.F32_OPS_PER_S
    return ops, nbytes, rate


def bound_s(cur_lens: Sequence[int], S: int, H: int, KV: int, D: int,
            cache_itemsize: int = 2) -> float:
    ops, nbytes, rate = cost(cur_lens, S, H, KV, D, cache_itemsize)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / rate)
