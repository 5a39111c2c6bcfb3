"""Frozen count of one decode step of a decoder transformer: the least
time the card could take for it, max(operations at the float32 rate,
bytes at the memory's rate).  Bytes: every weight outside the routed
experts read once in float32 (attention, norms, the feed-forward layer
of a dense model or a mixture's router and shared experts, the LM
head, the rows of the embedding the step gathers), of the routed
experts only those the step's rows select, and of the bfloat16 cache
the rows each row attends over (its k and v), and the new row written.
A configuration is a mixture of experts where ``n_routed_experts`` > 0,
else dense with a SwiGLU of width ``intermediate_size``.  The experts
selected are counted as the expected number of distinct experts that B
rows choosing k of E each select under uniform routing,
E (1 - (1 - k/E)^B), in every layer (``routed_distinct_ratio``, read
by each run's check, sets the reference's routing beside it)."""

from __future__ import annotations

from typing import Sequence

import peaks


def distinct_experts(E: int, k: int, B: int) -> float:
    return E * (1.0 - (1.0 - k / E) ** B)


def step(cfg: dict, cur_lens: Sequence[int], max_len: int):
    """(operations, bytes) of one decode step over rows at valid cache
    lengths ``cur_lens`` (the new token's row included)."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    V, E = cfg["vocab_size"], int(cfg.get("n_routed_experts", 0))
    B = len(cur_lens)
    rows = sum(min(int(c), max_len) for c in cur_lens)
    attn = d * H * hd + 2 * d * KV * hd + H * hd * d
    if E:
        k, f = cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
        ffn = 3 * d * f * cfg["n_shared_experts"] + d * E
        routed = L * distinct_experts(E, k, B) * 3 * d * f
        active = L * k * 3 * d * f
    else:
        ffn = 3 * d * cfg["intermediate_size"]
        routed = active = 0
    dense = L * (attn + ffn + 2 * d) + d * V + d
    nbytes = 4 * (dense + routed + B * d) \
        + L * 2 * (rows + B) * KV * hd * 2
    ops = 2 * B * (dense + active) + L * 4 * hd * H * rows
    return ops, nbytes


def bound_s(cfg: dict, cur_lens: Sequence[int], max_len: int) -> float:
    ops, nbytes = step(cfg, cur_lens, max_len)
    return max(ops / peaks.F32_OPS_PER_S, nbytes / peaks.HBM_BYTES_PER_S)
