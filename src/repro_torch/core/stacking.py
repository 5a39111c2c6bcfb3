"""STACKING (Algorithm 1): clustering -> packing -> batching, with an outer
linear search over the auxiliary target T*.

The two empirical insights it encodes (Sec. III-B):
  (i)  b >> a in g(X) = aX + b  =>  batches should be as large as possible;
  (ii) early denoising steps improve quality far more than later ones
       =>  step counts should be *balanced* across services.

T* is the expected per-service step count; services whose best-case final
step count T'_k falls at or below T* form the priority cluster F.

Quality-function-agnostic: the inner pass never evaluates FID; only the
outer search does, through whatever QualityModel is supplied.  A copy of
``repro.core.stacking``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import arrays
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import ServiceRequest


def stacking_pass(service_ids: Sequence[int], tau_prime: Dict[int, float],
                  delay: DelayModel, t_star: int,
                  offsets: Optional[Dict[int, int]] = None) -> BatchPlan:
    """One clustering-packing-batching sweep for a fixed T* (Alg. 1 l.3-7).

    ``offsets`` (steps a service already executed before this plan,
    default zero) shift the projected counts ``Tp`` the priority
    cluster is formed on, turning T* into a *total*-step water level —
    the offset-native sweep of ``repro_torch.core.offset``.  With no offsets
    this is the paper's Algorithm 1 inner pass exactly.
    """
    a, b = delay.a, delay.b
    off = offsets or {}
    taup = {k: float(tau_prime[k]) for k in service_ids}
    Tc = {k: 0 for k in service_ids}
    active = [k for k in service_ids if taup[k] >= delay.min_task_delay()]

    batches: List[List] = []
    start_times: List[float] = []
    t = 0.0

    while active:
        # ---- clustering (Eqs. 15-18, offset-shifted) ---------------------
        Te = {k: delay.max_steps(taup[k]) for k in active}
        Tp = {k: off.get(k, 0) + Tc[k] + Te[k] for k in active}
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
            # >= 1 whenever t_star >= 1 (the only levels the outer
            # searches sweep).  The explicit clamp states that
            # invariant here rather than leaving a degenerate negative
            # cap to be absorbed — identically — by the generic
            # max(1, ...) below, where the branch's reasoning is lost
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
             quality: QualityModel, t_star_max: int = 0,
             engine: Optional[str] = None) -> BatchPlan:
    """Algorithm 1: search T* in 1..T*max, keep the best mean quality.

    ``engine`` selects the implementation: ``"vec"`` (the process
    default — ``repro_torch.core.arrays``, all T* candidates swept as one
    batched array kernel), ``"scalar"`` (this module's reference
    loop), or any registered backend such as ``"torch"``
    (``repro_torch.core.torchplan``, the T* sweep on the card).  vec and
    scalar return bit-identical plans; registered backends match within
    their documented tolerance, 1e-9 mean FID
    (tests/test_torch_planner.py).
    """
    eng = arrays.resolve_engine(engine)
    impl = arrays.engine_impl(eng)
    if impl is not None:
        return impl.stacking(services, tau_prime, delay, quality,
                             t_star_max)
    if eng == "vec":
        return arrays.stacking_vec(services, tau_prime, delay, quality,
                                   t_star_max)
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
