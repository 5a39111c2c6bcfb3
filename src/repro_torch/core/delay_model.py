"""Per-batch denoising delay model — the paper's Eq. (4):

    g(X) = a * X + b * ||X||_0

a = marginal per-task compute slope, b = fixed overhead per batch.  The
paper measures a=0.0240, b=0.3543 s for DDIM/CIFAR-10 on an RTX-3050;
``fit`` re-derives (a, b) from measurements on the hardware at hand.
A copy of the parts of ``repro.core.delay_model`` the static path uses.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# Paper's measured constants (Fig. 1a, RTX-3050).
PAPER_A = 0.0240
PAPER_B = 0.3543


@dataclasses.dataclass(frozen=True)
class DelayModel:
    a: float = PAPER_A
    b: float = PAPER_B

    def g(self, batch_size: int) -> float:
        """Delay of one denoising batch of the given size (Eq. 4)."""
        if batch_size <= 0:
            return 0.0
        return self.a * batch_size + self.b

    def min_task_delay(self) -> float:
        return self.g(1)

    def max_steps(self, budget: float) -> int:
        """T^e in Eq. (16): tasks completable in `budget` seconds assuming
        dedicated (size-1) batches."""
        if budget <= 0:
            return 0
        return int(budget / (self.a + self.b))

    def scaled(self, factor: float) -> "DelayModel":
        """This model with both coefficients inflated by ``factor``."""
        return DelayModel(a=self.a * factor, b=self.b * factor)


def fit(batch_sizes: Sequence[int], delays: Sequence[float]) -> DelayModel:
    """Least-squares fit of (a, b) — the paper's Fig. 1a fitting step."""
    x = np.asarray(batch_sizes, dtype=np.float64)
    y = np.asarray(delays, dtype=np.float64)
    if x.shape != y.shape or x.size < 2:
        raise ValueError("fit needs >= 2 matching (batch_size, delay) pairs")
    A = np.stack([x, np.ones_like(x)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    return DelayModel(a=float(a), b=float(b))
