"""Batch-denoising plan IR.

A plan is the solution of problem (P2): an ordered list of batches, each a
set of (service_id, step_index) denoising tasks, with start times.  It maps
1:1 onto the paper's decision variables:

    x_{k,n}^s = 1  <=>  (k, s) in batches[n]
    t_n            =   start_times[n]
    T_k            =   steps_completed[k]

``validate`` checks the paper's constraints (1), (2), (6), (7) plus the
per-service generation deadline (14).  A copy of ``repro.core.plan``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.delay_model import DelayModel


def _require(ok: bool, msg: str) -> None:
    # raises the reference's AssertionError, also under ``python -O``
    if not ok:
        raise AssertionError(msg)


@dataclasses.dataclass
class BatchPlan:
    batches: List[List[Tuple[int, int]]]     # batches[n] = [(k, s), ...]
    start_times: List[float]                 # t_n
    steps_completed: Dict[int, int]          # T_k
    delay: DelayModel

    @property
    def num_batches(self) -> int:
        return len(self.batches)

    def batch_sizes(self) -> List[int]:
        return [len(b) for b in self.batches]

    def completion_time(self, k: int) -> float:
        """D_k^cg (Eq. 5): end time of service k's last batch."""
        t_done = 0.0
        for t_n, batch in zip(self.start_times, self.batches):
            if any(kk == k for kk, _ in batch):
                t_done = t_n + self.delay.g(len(batch))
        return t_done

    def makespan(self) -> float:
        if not self.batches:
            return 0.0
        return self.start_times[-1] + self.delay.g(len(self.batches[-1]))

    def validate(self, gen_deadlines: Dict[int, float] = None,
                 tol: float = 1e-7) -> None:
        """Raise AssertionError on any violated constraint."""
        seen = set()
        for n, batch in enumerate(self.batches):
            _require(len(batch) > 0, f"empty batch {n}")
            ks = [k for k, _ in batch]
            _require(len(set(ks)) == len(ks),
                     f"service repeated within batch {n}")
            for task in batch:
                _require(task not in seen,                          # (2)
                         f"task {task} scheduled twice")
                seen.add(task)

        # (2) completeness: every step 0..T_k-1 scheduled exactly once
        for k, T in self.steps_completed.items():
            for s in range(T):
                _require((k, s) in seen, f"missing task ({k},{s})")
        _require(len(seen) == sum(self.steps_completed.values()),
                 "extra tasks beyond T_k")

        # (6) sequential batches: t_{n+1} >= t_n + g(X_n)
        for n in range(len(self.batches) - 1):
            end = self.start_times[n] + self.delay.g(len(self.batches[n]))
            _require(self.start_times[n + 1] >= end - tol,
                     f"batch {n + 1} starts before batch {n} ends")

        # (7) per-service precedence: step s completes before s+1 starts
        task_batch = {}
        for n, batch in enumerate(self.batches):
            for k, s in batch:
                task_batch[(k, s)] = n
        for (k, s), n in task_batch.items():
            nxt = task_batch.get((k, s + 1))
            if nxt is not None:
                end = self.start_times[n] + self.delay.g(len(self.batches[n]))
                _require(self.start_times[nxt] >= end - tol,
                         f"service {k}: step {s + 1} starts before step "
                         f"{s} ends")

        # (14) generation deadline
        if gen_deadlines:
            for k, tau in gen_deadlines.items():
                T = self.steps_completed.get(k, 0)
                if T > 0:
                    _require(self.completion_time(k) <= tau + tol,
                             f"service {k} finishes at "
                             f"{self.completion_time(k):.3f} > "
                             f"tau'={tau:.3f}")
