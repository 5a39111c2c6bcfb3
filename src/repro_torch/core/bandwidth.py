"""Bandwidth allocation across AIGC services — problem (P1).

Paper's method: particle swarm optimization (PSO) over the bandwidth
simplex; each particle's fitness runs the inner batch-denoising solver
(STACKING) on the induced generation budgets
tau'_k = tau_k - S/(B_k eta_k).  Also the equal split (Sec. IV
baseline), the closed-form equal-transmission-delay split ``inv_se``
and the deterministic ``coordinate_refine`` hill-climb.

A copy of ``repro.core.bandwidth``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import Scenario

# A scheduler takes (services, tau_prime, delay, quality) -> BatchPlan.
SchedulerFn = Callable[..., "BatchPlan"]


def tau_prime_of(scn: Scenario, alloc: np.ndarray) -> Dict[int, float]:
    return {
        s.id: s.deadline - s.tx_delay(alloc[i], scn.content_bits)
        for i, s in enumerate(scn.services)
    }


def make_plan(scn: Scenario, alloc: np.ndarray, scheduler: SchedulerFn,
              delay: DelayModel, quality: QualityModel):
    """P1->P2 composition: generation budgets under an allocation, then
    the scheduler's batch plan.  Returns ``(tau_prime, plan)``."""
    tp = tau_prime_of(scn, alloc)
    return tp, scheduler(scn.services, tp, delay, quality)


def evaluate(scn: Scenario, alloc: np.ndarray, scheduler: SchedulerFn,
             delay: DelayModel, quality: QualityModel) -> float:
    """Mean FID achieved under a bandwidth allocation (lower = better)."""
    _, plan = make_plan(scn, alloc, scheduler, delay, quality)
    return quality.mean_fid(
        [plan.steps_completed[s.id] for s in scn.services])


def equal_allocate(scn: Scenario) -> np.ndarray:
    return np.full(scn.K, scn.total_bandwidth_hz / scn.K)


def inv_se_allocate(scn: Scenario) -> np.ndarray:
    """Equal transmission delay: B_k proportional to 1/eta_k."""
    inv = np.array([1.0 / s.spectral_eff for s in scn.services])
    return scn.total_bandwidth_hz * inv / inv.sum()


@dataclasses.dataclass
class PSOResult:
    alloc: np.ndarray
    fid: float
    history: list


def pso_allocate(scn: Scenario, scheduler: SchedulerFn, delay: DelayModel,
                 quality: QualityModel, *, num_particles: int = 24,
                 iters: int = 40, w: float = 0.72, c1: float = 1.5,
                 c2: float = 1.5, seed: int = 0,
                 min_frac: float = 1e-3) -> PSOResult:
    """PSO on the bandwidth simplex (the paper's Sec. III-C solver)."""
    rng = np.random.default_rng(seed)
    K, B = scn.K, scn.total_bandwidth_hz

    def project(x):
        x = np.clip(x, min_frac * B, None)
        return x * (B / x.sum())

    # seed the swarm with the two closed-form allocations + random simplex
    pts = [equal_allocate(scn), inv_se_allocate(scn)]
    while len(pts) < num_particles:
        pts.append(project(rng.dirichlet(np.ones(K)) * B))
    X = np.stack(pts)
    V = np.zeros_like(X)

    fit = np.array([evaluate(scn, x, scheduler, delay, quality) for x in X])
    pbest, pbest_fit = X.copy(), fit.copy()
    g = int(np.argmin(fit))
    gbest, gbest_fit = X[g].copy(), float(fit[g])
    history = [gbest_fit]

    for _ in range(iters):
        r1 = rng.random((num_particles, K))
        r2 = rng.random((num_particles, K))
        V = w * V + c1 * r1 * (pbest - X) + c2 * r2 * (gbest[None] - X)
        X = np.stack([project(x) for x in (X + V)])
        fit = np.array(
            [evaluate(scn, x, scheduler, delay, quality) for x in X])
        upd = fit < pbest_fit
        pbest[upd], pbest_fit[upd] = X[upd], fit[upd]
        g = int(np.argmin(pbest_fit))
        if pbest_fit[g] < gbest_fit:
            gbest, gbest_fit = pbest[g].copy(), float(pbest_fit[g])
        history.append(gbest_fit)

    return PSOResult(alloc=gbest, fid=gbest_fit, history=history)


def coordinate_refine(scn: Scenario, alloc: np.ndarray,
                      scheduler: SchedulerFn, delay: DelayModel,
                      quality: QualityModel, *, rounds: int = 6,
                      step_frac: float = 0.05,
                      min_frac: float = 1e-3) -> PSOResult:
    """Deterministic refinement: repeatedly try moving a slice of
    bandwidth from donor k to receiver j; keep improving moves."""
    B = scn.total_bandwidth_hz
    cur = alloc.copy()
    cur_fid = evaluate(scn, cur, scheduler, delay, quality)
    history = [cur_fid]
    K = scn.K
    step = step_frac * B
    for _ in range(rounds):
        improved = False
        for donor in range(K):
            for recv in range(K):
                # re-check per transfer: accepted moves shrink the donor,
                # which must never pass the min_frac floor
                if cur[donor] - step < min_frac * B:
                    break
                if recv == donor:
                    continue
                cand = cur.copy()
                cand[donor] -= step
                cand[recv] += step
                f = evaluate(scn, cand, scheduler, delay, quality)
                if f < cur_fid - 1e-9:
                    cur, cur_fid = cand, f
                    improved = True
        history.append(cur_fid)
        if not improved:
            step /= 2.0
            if step < 1e-4 * B:
                break
    return PSOResult(alloc=cur, fid=cur_fid, history=history)
