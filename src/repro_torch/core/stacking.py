"""STACKING (Algorithm 1): clustering -> packing -> batching, with an outer
linear search over the auxiliary target T*.

The two empirical insights it encodes (Sec. III-B):
  (i)  b >> a in g(X) = aX + b  =>  batches should be as large as possible;
  (ii) early denoising steps improve quality far more than later ones
       =>  step counts should be *balanced* across services.

A copy of the scalar reference loop of ``repro.core.stacking`` (the
original's default array engine returns bit-identical plans, which
tests/test_arrays.py enforces there).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import ServiceRequest


def stacking_pass(service_ids: Sequence[int], tau_prime: Dict[int, float],
                  delay: DelayModel, t_star: int) -> BatchPlan:
    """One clustering-packing-batching sweep for a fixed T* (Alg. 1 l.3-7)."""
    a, b = delay.a, delay.b
    taup = {k: float(tau_prime[k]) for k in service_ids}
    Tc = {k: 0 for k in service_ids}
    active = [k for k in service_ids if taup[k] >= delay.min_task_delay()]

    batches: List[List] = []
    start_times: List[float] = []
    t = 0.0

    while active:
        # ---- clustering (Eqs. 15-18) -------------------------------------
        Te = {k: delay.max_steps(taup[k]) for k in active}
        Tp = {k: Tc[k] + Te[k] for k in active}
        order = sorted(active, key=lambda k: (Tp[k], taup[k], k))
        F = [k for k in order if Tp[k] <= t_star]

        # ---- packing (Eqs. 19-20) ----------------------------------------
        if F:
            te_max = max(Te[k] for k in F)
            tau_min = min(taup[k] for k in F)
            if te_max > 0:
                cap = math.floor((tau_min - b * te_max) / (a * te_max))
                x_n = max(len(F), min(len(active), cap))
            else:
                x_n = len(F)
        else:
            tp_min = min(Tp[k] for k in active)
            cap = math.floor(((a + b) * tp_min - b * t_star) / (a * t_star)) \
                if t_star > 0 else len(active)
            # an empty priority cluster forces tp_min > t_star, so cap
            # >= 1 whenever t_star >= 1
            x_n = min(len(active), max(1, cap))
        x_n = max(1, min(x_n, len(active)))

        # ---- batching -----------------------------------------------------
        packed = order[:x_n]
        while packed:
            g = delay.g(len(packed))
            drop = [k for k in packed if taup[k] + 1e-12 < g]
            if not drop:
                break
            for k in drop:                      # cannot afford this batch ->
                packed.remove(k)                # service is finished
                active.remove(k)
        if not packed:
            continue

        g = delay.g(len(packed))
        batches.append([(k, Tc[k]) for k in packed])
        start_times.append(t)
        t += g
        for k in active:                         # wall clock advances for all
            taup[k] -= g                         # (Eq. 15)
        for k in packed:
            Tc[k] += 1
        # services that can no longer fit even a dedicated batch are done
        active = [k for k in active
                  if taup[k] + 1e-12 >= delay.min_task_delay()]

    return BatchPlan(batches=batches, start_times=start_times,
                     steps_completed=Tc, delay=delay)


def stacking(services: Sequence[ServiceRequest],
             tau_prime: Dict[int, float], delay: DelayModel,
             quality: QualityModel, t_star_max: int = 0) -> BatchPlan:
    """Algorithm 1: search T* in 1..T*max, keep the best mean quality."""
    ids = [s.id for s in services]
    if t_star_max <= 0:
        t_star_max = max(1, max(delay.max_steps(tau_prime[k]) for k in ids))

    best_plan, best_q = None, float("inf")
    for t_star in range(1, t_star_max + 1):
        plan = stacking_pass(ids, tau_prime, delay, t_star)
        q = quality.mean_fid([plan.steps_completed[k] for k in ids])
        if q < best_q - 1e-12:
            best_plan, best_q = plan, q
    if best_plan is None:
        raise ValueError("stacking: no T* candidate produced a plan")
    return best_plan


def check_engine(engine) -> None:
    """Raise for a planning engine this port does not have.  The
    reference's ``repro.core.arrays`` picks a vectorised or jax engine;
    the port has only the scalar loops above (``None`` = ``"scalar"``),
    which give the reference's ``vec`` plans bit for bit."""
    if engine not in (None, "scalar"):
        raise NotImplementedError(
            f"planning engine {engine!r} is not ported; only 'scalar' "
            f"(ROADMAP.md, queue 1 item 8: the planner device engine)")
