"""Token data pipeline: synthetic (deterministic PRNG) and file-backed
(uint16 memmap) sources, yielding (tokens, labels) next-token pairs as
int32 numpy arrays.

The port's copy of ``repro.training.data`` (NumPy only, held ``==`` to
it by tests/test_torch_core_copy.py).  ``shard_batch`` slices a global
batch by data-parallel rank.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    source: str = "synthetic"     # synthetic | file
    path: Optional[str] = None
    seed: int = 0


def synthetic_batches(cfg: DataConfig) -> Iterator[Tuple[np.ndarray,
                                                         np.ndarray]]:
    """Zipf-ish synthetic tokens — deterministic, infinitely repeatable."""
    rng = np.random.default_rng(cfg.seed)
    ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    while True:
        toks = rng.choice(cfg.vocab_size, size=(cfg.global_batch,
                                                cfg.seq_len + 1), p=probs)
        toks = toks.astype(np.int32)
        yield toks[:, :-1], toks[:, 1:]


def file_batches(cfg: DataConfig) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    data = np.memmap(cfg.path, dtype=np.uint16, mode="r")
    n = len(data) - cfg.seq_len - 1
    rng = np.random.default_rng(cfg.seed)
    while True:
        starts = rng.integers(0, n, size=cfg.global_batch)
        toks = np.stack([data[s:s + cfg.seq_len + 1] for s in starts])
        toks = toks.astype(np.int32) % cfg.vocab_size
        yield toks[:, :-1], toks[:, 1:]


def batches(cfg: DataConfig):
    if cfg.source == "file":
        return file_batches(cfg)
    return synthetic_batches(cfg)


def shard_batch(batch: np.ndarray, rank: int, world: int) -> np.ndarray:
    assert batch.shape[0] % world == 0
    per = batch.shape[0] // world
    return batch[rank * per:(rank + 1) * per]
