"""Per-batch denoising delay model — the paper's Eq. (4):

    g(X) = a * X + b * ||X||_0

a = marginal per-task compute slope, b = fixed overhead per batch.  The
paper measures a=0.0240, b=0.3543 s for DDIM/CIFAR-10 on an RTX-3050;
``fit`` re-derives (a, b) from measurements on the hardware at hand.
A copy of ``repro.core.delay_model`` but its TPU estimate: ``refit``
and ``RollingDelayFit`` are the closed loop's measurement half
(``core/execution.py``).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

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

    def refit(self, batch_sizes: Sequence[int],
              delays: Sequence[float]) -> "DelayModel":
        """Refit from measured ``(batch_size, seconds)`` telemetry.

        With two or more distinct batch sizes this is the clamped
        least-squares fit (a >= 0 so bigger batches never look cheaper,
        b > 0 so g stays positive).  With a single distinct size the
        slope is unobservable, so the current (a, b) shape is kept and
        both coefficients are rescaled so g matches the mean measured
        delay at that size.
        """
        x = np.asarray(batch_sizes, dtype=np.float64)
        y = np.asarray(delays, dtype=np.float64)
        if x.shape != y.shape or x.size == 0:
            raise ValueError("refit needs matching, non-empty "
                             "batch_sizes/delays")
        if np.unique(x).size >= 2:
            m = fit(x, y)
            # a gets a tiny positive floor, not zero: the planners
            # divide by it (packing caps, Eqs. 19-20)
            a, b = max(m.a, 1e-9), m.b
        else:
            predicted = self.g(int(x[0]))
            ratio = float(np.mean(y)) / max(predicted, 1e-12)
            a, b = self.a * ratio, self.b * ratio
        return DelayModel(a=float(a), b=float(max(b, 1e-9)))


def fit(batch_sizes: Sequence[int], delays: Sequence[float]) -> DelayModel:
    """Least-squares fit of (a, b) — the paper's Fig. 1a fitting step."""
    x = np.asarray(batch_sizes, dtype=np.float64)
    y = np.asarray(delays, dtype=np.float64)
    if x.shape != y.shape or x.size < 2:
        raise ValueError("fit needs >= 2 matching (batch_size, delay) pairs")
    A = np.stack([x, np.ones_like(x)], axis=1)
    (a, b), *_ = np.linalg.lstsq(A, y, rcond=None)
    return DelayModel(a=float(a), b=float(b))


class RollingDelayFit:
    """Rolling least-squares window over measured per-batch delays.

    ``ExecutionLoop`` feeds it one ``(batch_size, seconds)`` pair per
    executed batch; ``model()`` returns the refit ``DelayModel`` over
    the last ``window`` observations (the prior's shape rescaled while
    only one distinct batch size has been seen, see
    ``DelayModel.refit``).
    """

    def __init__(self, window: int = 64,
                 prior: Optional[DelayModel] = None):
        if window < 2:
            raise ValueError(f"window must be >= 2, got {window}")
        self.window = int(window)
        self.prior = prior if prior is not None else DelayModel()
        self._obs: "collections.deque[Tuple[int, float]]" = \
            collections.deque(maxlen=self.window)

    def observe(self, batch_size: int, seconds: float) -> None:
        self._obs.append((int(batch_size), float(seconds)))

    def __len__(self) -> int:
        return len(self._obs)

    @property
    def ready(self) -> bool:
        return len(self._obs) >= 2

    def model(self, headroom: float = 1.0) -> DelayModel:
        """Refit over the window; ``headroom > 1`` inflates the result
        so replans keep slack against timing noise."""
        if not self._obs:
            return self.prior.scaled(headroom)
        sizes = [s for s, _ in self._obs]
        secs = [d for _, d in self._obs]
        return self.prior.refit(sizes, secs).scaled(headroom)
