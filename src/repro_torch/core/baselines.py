"""Baseline batch-denoising schedulers from Sec. IV.

* single_instance [14]: deadline-ascending, one service at a time, no
  batching.  (Given a per-service step target T* searched like Alg. 1 —
  a generous reading; the naive run-to-deadline variant is strictly worse.)
* greedy: everything in one batch, drop services as deadlines expire.
* fixed_size: batch size floor(K/2), tighter deadlines first, shrink when
  fewer services remain.

All share STACKING's time accounting so comparisons are apples-to-apples.
A copy of ``repro.core.baselines``.
"""

from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import ServiceRequest


def single_instance(services: Sequence[ServiceRequest],
                    tau_prime: Dict[int, float], delay: DelayModel,
                    quality: QualityModel) -> BatchPlan:
    ids = sorted((s.id for s in services), key=lambda k: tau_prime[k])
    t_star_max = max(1, max(delay.max_steps(tau_prime[k]) for k in ids))
    g1 = delay.g(1)

    best_plan, best_q = None, float("inf")
    for t_star in range(1, t_star_max + 1):
        t = 0.0
        batches, starts, Tc = [], [], {k: 0 for k in ids}
        for k in ids:
            # service k runs dedicated size-1 batches until it reaches
            # t_star steps or its remaining deadline expires
            while Tc[k] < t_star and tau_prime[k] - t >= g1:
                batches.append([(k, Tc[k])])
                starts.append(t)
                t += g1
                Tc[k] += 1
        # counts in services order — the make_plan convention shared by
        # every quality.mean_fid call (progress-aware online replans
        # credit prior steps positionally, repro_torch.core.online)
        q = quality.mean_fid([Tc[s.id] for s in services])
        if q < best_q - 1e-12:
            best_plan = BatchPlan(batches=batches, start_times=starts,
                                  steps_completed=Tc, delay=delay)
            best_q = q
    return best_plan


def greedy_batching(services: Sequence[ServiceRequest],
                    tau_prime: Dict[int, float], delay: DelayModel,
                    quality: QualityModel = None) -> BatchPlan:
    taup = {s.id: float(tau_prime[s.id]) for s in services}
    active = [s.id for s in services
              if taup[s.id] >= delay.min_task_delay()]
    batches, starts, Tc = [], [], {s.id: 0 for s in services}
    t = 0.0
    while active:
        # drop services that cannot afford the next full batch
        while active:
            g = delay.g(len(active))
            drop = [k for k in active if taup[k] + 1e-12 < g]
            if not drop:
                break
            for k in drop:
                active.remove(k)
        if not active:
            break
        g = delay.g(len(active))
        batches.append([(k, Tc[k]) for k in active])
        starts.append(t)
        t += g
        for k in active:
            taup[k] -= g
            Tc[k] += 1
        active = [k for k in active
                  if taup[k] + 1e-12 >= delay.min_task_delay()]
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=Tc, delay=delay)


def fixed_size_batching(services: Sequence[ServiceRequest],
                        tau_prime: Dict[int, float], delay: DelayModel,
                        quality: QualityModel = None,
                        batch_size: int = 0) -> BatchPlan:
    K = len(services)
    size = batch_size or max(1, K // 2)
    taup = {s.id: float(tau_prime[s.id]) for s in services}
    active = [s.id for s in services
              if taup[s.id] >= delay.min_task_delay()]
    batches, starts, Tc = [], [], {s.id: 0 for s in services}
    t = 0.0
    while active:
        order = sorted(active, key=lambda k: (taup[k], k))
        packed = order[:min(size, len(order))]
        while packed:
            g = delay.g(len(packed))
            drop = [k for k in packed if taup[k] + 1e-12 < g]
            if not drop:
                break
            for k in drop:
                packed.remove(k)
                active.remove(k)
        if not packed:
            active = [k for k in active
                      if taup[k] + 1e-12 >= delay.min_task_delay()]
            continue
        g = delay.g(len(packed))
        batches.append([(k, Tc[k]) for k in packed])
        starts.append(t)
        t += g
        for k in active:
            taup[k] -= g
        for k in packed:
            Tc[k] += 1
        active = [k for k in active
                  if taup[k] + 1e-12 >= delay.min_task_delay()]
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=Tc, delay=delay)
