"""The one traffic generator: a cell's traffic file, a seed and a round
index give that round's K service requests.

A traffic file (``portbench/workloads/<cell>.json``) holds only data:

    K                    services a round (the paper's static batch)
    deadline_s           [lo, hi], the range of the deadlines
    spectral_eff         [lo, hi], the range of eta_k (bit/s/Hz)
    total_bandwidth_hz   the cell's bandwidth budget
    content_bits         bits of one delivered result
    allocator, scheduler names of the program's registered components
    delay                {"a", "b"}: g(X) = a X + b seconds, the g that
                         plans every round (the closed loop refits it)
    warm_batches         batch sizes set-up runs a step at
    trace_rounds         rounds the traced run profiles
    check                sizes of the output comparison (samples)

plus what the configuration's driver reads (prompt and cache lengths).
Every round holds the same K deadlines, the midpoints of K equal slices
of the range (the paper's uniform law, stratified), and the same K
spectral efficiencies; the seed and the round index draw only their
order: which request gets which deadline and which eta.  So every seed
and every round carry the same work in another order, and two runs
differ by the system's noise, not by a lighter or heavier draw.  Every
number is fixed by the file and ``--seed``; nothing depends on a time
measured in the run.  Service ids are unique across a run: round
r's services are r * K .. r * K + K - 1, the warm-up round's lie past
every timed round's.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

WARMUP_ROUND = 1_000_000


@dataclasses.dataclass(frozen=True)
class Request:
    id: int
    deadline: float
    spectral_eff: float


def rng(seed: int, *key: int) -> np.random.Generator:
    """A generator keyed by the run's seed and a path of small ints."""
    return np.random.default_rng([int(seed) % 2**64, *key])


def strata(lo: float, hi: float, K: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(K) + 0.5) / K


def round_requests(traffic: dict, seed: int, r: int) -> List[Request]:
    K = int(traffic["K"])
    g = rng(seed, r)
    dl = strata(*traffic["deadline_s"], K)[g.permutation(K)]
    eta = strata(*traffic["spectral_eff"], K)[g.permutation(K)]
    return [Request(id=r * K + k, deadline=float(d), spectral_eff=float(e))
            for k, (d, e) in enumerate(zip(dl, eta))]
