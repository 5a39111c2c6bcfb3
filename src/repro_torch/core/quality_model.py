"""Content-quality-vs-steps model — the paper's Fig. 1b.

FID(T) = alpha * T^(-beta) + gamma, fitted to the DDIM paper's CIFAR-10
measurements (eta=0: FID 13.36 / 6.84 / 4.67 / 4.16 at T = 10/20/50/100).
STACKING is agnostic to the quality function; ``QualityModel`` is the
interface.  A copy of ``repro.core.quality_model`` minus the fitting
helper.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence

import numpy as np


class QualityModel(Protocol):
    def fid(self, steps: int) -> float: ...

    def mean_fid(self, step_counts: Sequence[int]) -> float: ...


@dataclasses.dataclass(frozen=True)
class PowerLawFID:
    alpha: float = 491.0
    beta: float = 1.72
    gamma: float = 4.0
    fid_at_zero: float = 550.0   # FID of pure noise (service outage);
                                 # must dominate fid(1)=alpha+gamma=495

    def fid(self, steps: int) -> float:
        if steps <= 0:
            return self.fid_at_zero
        return self.alpha * steps ** (-self.beta) + self.gamma

    def mean_fid(self, step_counts: Sequence[int]) -> float:
        return float(np.mean([self.fid(t) for t in step_counts]))
