"""The scheduler registry entries of the port (``SCHEDULERS``,
``api/registry.py``): the paper's Algorithm 1, its Sec.-IV baselines,
the balanced ``equal_steps`` baseline, the exact ``optimal`` search
for tiny instances, and the offset-native ``stacking_offset``
(progress-aware replanning, ``repro_torch.core.offset``) — every name
``repro.api.schedulers`` registers, its ``*_jax`` entries read as
``*_torch``.

All share the ``Scheduler`` signature
``(services, tau_prime, delay, quality) -> BatchPlan``;
``stacking_offset`` also has ``plan(..., offsets)``, which the online
replanner dispatches to.  ``stacking``, ``equal_steps`` and
``stacking_offset`` follow the process-wide planner engine
(``repro_torch.core.arrays``, ``"vec"`` by default); the ``*_scalar``
entries pin the reference per-level loops and the ``*_torch`` entries
the device engine (``repro_torch.core.torchplan``, on the card unless
``torchplan.device_scope("cpu")`` asks for the CPU).
"""

from __future__ import annotations

from typing import Dict, Sequence

from repro_torch.api.registry import register_scheduler
from repro_torch.core import arrays
from repro_torch.core.baselines import (fixed_size_batching, greedy_batching,
                                        single_instance)
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.offset import StackingOffset, stacking_offset
from repro_torch.core.optimal import optimal_plan
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import ServiceRequest
from repro_torch.core.stacking import stacking


def stacking_scalar(services: Sequence[ServiceRequest],
                    tau_prime: Dict[int, float], delay: DelayModel,
                    quality: QualityModel) -> BatchPlan:
    """Algorithm 1 pinned to the scalar reference loop."""
    return stacking(services, tau_prime, delay, quality, engine="scalar")


def stacking_torch(services: Sequence[ServiceRequest],
                   tau_prime: Dict[int, float], delay: DelayModel,
                   quality: QualityModel) -> BatchPlan:
    """Algorithm 1 pinned to the device engine
    (``repro_torch.core.torchplan``): the whole T* sweep on the card.
    Equivalent to ``stacking`` within 1e-9 mean FID."""
    return stacking(services, tau_prime, delay, quality, engine="torch")


def equal_steps(services: Sequence[ServiceRequest],
                tau_prime: Dict[int, float], delay: DelayModel,
                quality: QualityModel) -> BatchPlan:
    """Balanced baseline: every service targets the *same* step count T*,
    batched together each step; T* searched like Algorithm 1's outer loop.
    Isolates the paper's insight (ii) — balanced step counts — from its
    clustering/packing machinery.  Dispatches to the active engine's
    lockstep sweep (array-native or a registered backend such as
    ``torch``) unless the scalar engine is selected."""
    eng = arrays.get_engine()
    impl = arrays.engine_impl(eng)
    if impl is not None:
        return impl.equal_steps(services, tau_prime, delay, quality)
    if eng == "vec":
        return arrays.equal_steps_vec(services, tau_prime, delay, quality)
    ids = [s.id for s in services]
    feasible = [k for k in ids if delay.max_steps(tau_prime[k]) > 0]
    t_max = max([delay.max_steps(tau_prime[k]) for k in feasible],
                default=1)

    best_plan, best_q = None, float("inf")
    for t_star in range(1, max(1, t_max) + 1):
        taup = {k: float(tau_prime[k]) for k in ids}
        Tc = {k: 0 for k in ids}
        active = [k for k in ids if taup[k] >= delay.min_task_delay()]
        batches, starts, t = [], [], 0.0
        while active:
            # drop members that cannot afford the current shared batch
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
                      if Tc[k] < t_star
                      and taup[k] + 1e-12 >= delay.min_task_delay()]
        q = quality.mean_fid([Tc[k] for k in ids])
        if q < best_q - 1e-12:
            best_plan, best_q = BatchPlan(
                batches=batches, start_times=starts, steps_completed=Tc,
                delay=delay), q
    assert best_plan is not None
    return best_plan


register_scheduler("stacking", stacking)
register_scheduler("greedy", greedy_batching)
register_scheduler("fixed_size", fixed_size_batching, aliases=("fixed",))
register_scheduler("single_instance", single_instance, aliases=("single",))
register_scheduler("optimal", optimal_plan)
# the OffsetScheduler instance: statically identical to `stacking`
# (zero offsets delegate), offset-native under online replanning
register_scheduler("stacking_offset", stacking_offset,
                   aliases=("offset",))
# engine-pinned entries: the scalar reference loops and the device engine
register_scheduler("stacking_offset_scalar", StackingOffset("scalar"),
                   aliases=("offset_scalar",))
register_scheduler("stacking_offset_torch", StackingOffset("torch"),
                   aliases=("offset_torch",))
register_scheduler("stacking_scalar", stacking_scalar)
register_scheduler("stacking_torch", stacking_torch)
register_scheduler("equal_steps", equal_steps)
