"""End-to-end service simulator: composes a bandwidth allocation and a
batch-denoising plan into per-service timelines (Fig. 2a) and aggregate
quality (Figs. 2b/2c).  A copy of ``repro.core.simulator``'s static
``simulate``."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import Scenario


@dataclasses.dataclass
class ServiceOutcome:
    id: int
    deadline: float
    steps: int
    gen_delay: float          # D_k^cg
    tx_delay: float           # D_k^ct
    e2e_delay: float          # D_k^e2e
    fid: float
    met_deadline: bool


@dataclasses.dataclass
class SimResult:
    outcomes: List[ServiceOutcome]
    mean_fid: float
    outage_rate: float

    def summary(self) -> str:
        lines = [f"{'svc':>4} {'tau':>7} {'steps':>6} {'gen':>8} "
                 f"{'tx':>7} {'e2e':>8} {'fid':>8} ok"]
        for o in self.outcomes:
            lines.append(
                f"{o.id:>4} {o.deadline:7.2f} {o.steps:6d} "
                f"{o.gen_delay:8.3f} {o.tx_delay:7.3f} {o.e2e_delay:8.3f} "
                f"{o.fid:8.2f} {'Y' if o.met_deadline else 'N'}")
        lines.append(f"mean FID {self.mean_fid:.3f}  "
                     f"outage {self.outage_rate:.1%}")
        return "\n".join(lines)


def simulate(scn: Scenario, alloc: np.ndarray, plan: BatchPlan,
             quality: QualityModel) -> SimResult:
    outcomes = []
    for i, s in enumerate(scn.services):
        T = plan.steps_completed.get(s.id, 0)
        gen = plan.completion_time(s.id) if T > 0 else 0.0
        tx = s.tx_delay(alloc[i], scn.content_bits) if T > 0 else 0.0
        e2e = gen + tx
        outcomes.append(ServiceOutcome(
            id=s.id, deadline=s.deadline, steps=T, gen_delay=gen,
            tx_delay=tx, e2e_delay=e2e, fid=quality.fid(T),
            met_deadline=(T > 0 and e2e <= s.deadline + 1e-6)))
    mean_fid = float(np.mean([o.fid for o in outcomes]))
    outage = float(np.mean([0.0 if o.met_deadline else 1.0
                            for o in outcomes]))
    return SimResult(outcomes=outcomes, mean_fid=mean_fid,
                     outage_rate=outage)
