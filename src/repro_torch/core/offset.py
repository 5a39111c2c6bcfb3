"""Offset-native STACKING: progress-aware replanning under churn.

The online replanner (``repro_torch.core.online``) keeps per-service progress
``offsets`` (denoising steps already executed) and scores candidate
plans as ``fid(done + new)``.  Algorithm 1 itself, however, only
searches plans whose *new* step counts are balanced around a shared
horizon T* — a service at step 18/20 and one at step 2/20 are planned
against the same grid, wasting the paper's own insight that early steps
matter far more than later ones.

``StackingOffset`` plans natively in *total*-step space instead.  Its
outer search is a marginal-gain water-filling: because the quality
model is monotone with diminishing returns, granting the next step to
whichever service has the highest marginal gain
``fid(offset + t) - fid(offset + t + 1)`` until a common water level L
is reached is exactly the plan family "every service targets
``max(0, L - offset)`` additional steps".  Sweeping the level L
therefore *is* the greedy water-filling, with the schedule's time
feasibility enforced by the batching pass itself.  Each level is
realized two ways and both candidates scored:

  * *soft* (``offset_stacking_pass``) — Algorithm 1's clustering/
    packing sweep with the priority cluster formed on total projected
    counts, so nearly-done services sort behind the water level but
    stay live (a later replan can still extend them);
  * *hard* (``offset_pass``) — services at or above the level retire
    outright (zero new steps) and transmit their banked content, which
    frees batch slots but is irreversible once the plan is adopted
    (``_settle_no_step_services``).

Among objective-equal candidates the shorter makespan wins: replans
are myopic about future arrivals, and freeing the server earlier is
the one future-proofing signal available for free.

Two guard rails keep the scheduler safe to swap in anywhere:

  * with all-zero offsets it delegates to ``stacking`` outright, so the
    static path (and the first replan of any online run) is bit-for-bit
    Algorithm 1 (tests/test_torch_planner.py holds it);
  * with real progress it also scores Algorithm 1's own shared-horizon
    candidates (``stacking_pass`` over every T*) under the same
    progress-aware objective, so the chosen plan never scores worse
    than what the ``_OffsetQuality``-wrapped fallback would have
    picked.

The objective mirrors ``repro_torch.core.online._OffsetQuality`` exactly,
including the ``doomed`` rule: a partially-generated service whose
residual generation budget went negative can never deliver on time, so
its banked steps score ``fid(0)`` — without this, retiring a service
"for free" by starving its bandwidth would look attractive.

A copy of ``repro.core.offset``; ``engine="torch"`` pins the device
backend (``repro_torch.core.torchplan``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import arrays
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.online import _OffsetQuality
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import ServiceRequest
from repro_torch.core.stacking import stacking, stacking_pass


def offset_stacking_pass(service_ids: Sequence[int],
                         tau_prime: Dict[int, float], delay: DelayModel,
                         t_star: int,
                         offsets: Dict[int, int]) -> BatchPlan:
    """Algorithm 1's clustering-packing-batching sweep with the
    priority cluster formed on *total* projected step counts
    (``stacking_pass`` with its ``offsets`` parameter — one
    implementation, re-exported here under the offset-native name).

    A service at step 18/20 projects past the T* water level and sorts
    to the back of the packing order, so it only receives further steps
    when batch capacity is free — soft deprioritization, never a hard
    (irreversible) retirement.  With all-zero offsets this is
    ``stacking_pass`` exactly.
    """
    return stacking_pass(service_ids, tau_prime, delay, t_star,
                         offsets=offsets)


def offset_pass(service_ids: Sequence[int], tau_prime: Dict[int, float],
                delay: DelayModel, targets: Dict[int, int]) -> BatchPlan:
    """One lockstep sweep toward per-service *additional*-step targets.

    Every service still short of its target joins every batch (insight
    (i): batches as large as possible); members that cannot afford the
    current shared batch drop out with the steps they have, exactly as
    in ``equal_steps`` — which this generalizes from one shared target
    to a per-service vector.
    """
    taup = {k: float(tau_prime[k]) for k in service_ids}
    Tc = {k: 0 for k in service_ids}
    active = [k for k in service_ids
              if targets.get(k, 0) > 0
              and taup[k] >= delay.min_task_delay()]

    batches: List[List] = []
    starts: List[float] = []
    t = 0.0
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
                  if Tc[k] < targets[k]
                  and taup[k] + 1e-12 >= delay.min_task_delay()]
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=Tc, delay=delay)


class StackingOffset:
    """Offset-native scheduler (module docstring).

    Satisfies both scheduler signatures: calling the instance is the
    plain ``Scheduler`` signature (zero offsets — delegates to
    ``stacking``); ``plan`` is the ``OffsetScheduler`` extension the
    online replanner dispatches to when per-service progress exists.
    ``offsets`` is positional, aligned with ``services`` — the same
    convention ``_OffsetQuality`` uses for anonymous step-count lists.
    """

    name = "stacking_offset"
    supports_offsets = True        # the OffsetScheduler dispatch marker

    def __init__(self, engine: Optional[str] = None):
        # None = the process-wide engine; "scalar" pins this instance
        # to the reference per-level passes, any other registered
        # engine name (e.g. "torch") pins its backend
        self.engine = engine

    def __call__(self, services: Sequence[ServiceRequest],
                 tau_prime: Dict[int, float], delay: DelayModel,
                 quality: QualityModel) -> BatchPlan:
        return self.plan(services, tau_prime, delay, quality,
                         [0] * len(services))

    def plan(self, services: Sequence[ServiceRequest],
             tau_prime: Dict[int, float], delay: DelayModel,
             quality: QualityModel,
             offsets: Sequence[int]) -> BatchPlan:
        engine = arrays.resolve_engine(self.engine)
        ids = [s.id for s in services]
        off = {k: int(o) for k, o in zip(ids, offsets)}
        if not any(off.values()):
            # no progress anywhere: the static problem, solved by the
            # paper's Algorithm 1 bit-for-bit
            return stacking(services, tau_prime, delay, quality,
                            engine=engine)

        # the one source of truth for the progress-aware objective
        # (offset-shifted mean FID + doomed rule): scoring through the
        # same class the replanner wraps non-native schedulers with is
        # what makes the family-3 "never worse than the wrapped
        # fallback" guarantee hold by construction
        oq = _OffsetQuality(quality, [off[k] for k in ids])
        oq.refresh_doomed(services, tau_prime)

        headroom = {k: delay.max_steps(max(tau_prime[k], 0.0))
                    for k in ids}
        level_max = max(off[k] + headroom[k] for k in ids)
        t_new_max = max(1, max(headroom.values()))
        impl = arrays.engine_impl(engine)
        if impl is not None:
            return impl.offset_plan(ids, tau_prime, delay, oq, off,
                                    level_max, t_new_max)
        if engine == "vec":
            return self._plan_vec(ids, tau_prime, delay, oq, off,
                                  level_max, t_new_max)
        return self._plan_scalar(ids, tau_prime, delay, oq, off,
                                 level_max, t_new_max)

    def _plan_scalar(self, ids, tau_prime, delay, oq, off,
                     level_max, t_new_max) -> BatchPlan:
        """Reference search: one scalar pass per candidate level."""

        def score(plan: BatchPlan) -> float:
            return oq.mean_fid([plan.steps_completed.get(k, 0)
                                for k in ids])

        # the all-retire plan: schedule nothing, transmit what is banked
        # (the water level sits below every offset) — rarely best, but
        # it is the correct degenerate candidate when no further step
        # fits any budget
        best_plan = BatchPlan(batches=[], start_times=[],
                              steps_completed={k: 0 for k in ids},
                              delay=delay)
        best_q, best_ms = score(best_plan), 0.0

        def better(q: float, ms: float) -> bool:
            # objective first; among objective-equal plans prefer the
            # shorter makespan — the server frees earlier, which only
            # helps whatever arrives next (replans are myopic about
            # future arrivals, so this is the one future-proofing
            # signal available for free)
            if q < best_q - 1e-12:
                return True
            return q < best_q + 1e-12 and ms < best_ms - 1e-12

        # family 1 — Algorithm 1 clustered on TOTAL counts: soft
        # deprioritization, nearly-done services sort behind the T*
        # water level but stay live (a future replan can still extend
        # them)
        for level in range(1, level_max + 1):
            plan = offset_stacking_pass(ids, tau_prime, delay, level, off)
            q, ms = score(plan), plan.makespan()
            if better(q, ms):
                best_plan, best_q, best_ms = plan, q, ms

        # family 2 — water-filling over the total-step level L: service
        # k targets max(0, L - offset_k) additional steps (the greedy
        # marginal-gain order realized as a plan family); services at or
        # above the level retire outright and transmit their banked
        # content
        for level in range(1, level_max + 1):
            targets = {k: max(0, level - off[k]) for k in ids}
            if not any(targets.values()):
                continue
            plan = offset_pass(ids, tau_prime, delay, targets)
            q, ms = score(plan), plan.makespan()
            if better(q, ms):
                best_plan, best_q, best_ms = plan, q, ms

        # family 3 — Algorithm 1's shared-NEW-horizon candidates under
        # the same objective: guarantees this scheduler never picks a
        # plan that scores worse than the _OffsetQuality-wrapped
        # `stacking` fallback would have
        for t_star in range(1, t_new_max + 1):
            plan = stacking_pass(ids, tau_prime, delay, t_star)
            q, ms = score(plan), plan.makespan()
            if better(q, ms):
                best_plan, best_q, best_ms = plan, q, ms
        return best_plan

    def _plan_vec(self, ids, tau_prime, delay, oq, off,
                  level_max, t_new_max) -> BatchPlan:
        """The same three candidate families as ``_plan_scalar``, each
        swept as ONE batched array kernel (``repro_torch.core.arrays``) with
        per-round snapshots, scored row-wise under the identical
        objective/tie rules, and only the winner's batch list replayed.
        Bit-identical to the scalar search (tests/test_torch_planner.py)."""
        arr = arrays.ServiceArrays.build(ids, tau_prime, off)
        state = {"q": oq.mean_fid([0] * len(ids)), "ms": 0.0,
                 "pick": None}        # None = the all-retire empty plan

        def consider(q: float, ms: float, pick) -> None:
            # the scalar `better` rule: objective first, then shorter
            # makespan among objective-equal candidates
            if q < state["q"] - 1e-12 or \
                    (q < state["q"] + 1e-12 and ms < state["ms"] - 1e-12):
                state.update(q=q, ms=ms, pick=pick)

        levels = np.arange(1, level_max + 1, dtype=np.int64)
        # family 1 — Algorithm 1 clustered on TOTAL counts
        h1: list = []
        Tc1, ms1, _, _ = arrays._clustered_rounds(
            arr.ids, arr.tau_prime, arr.offsets, delay, levels,
            history=h1)
        for i, q in enumerate(arrays.score_rows(Tc1, oq).tolist()):
            consider(q, float(ms1[i]), ("clustered", i))

        # family 2 — lockstep water-filling over the total-step level
        targets = np.maximum(levels[:, None] - arr.offsets[None, :], 0)
        nonzero = targets.any(axis=1)
        h2: list = []
        Tc2, ms2, _, _ = arrays._lockstep_rounds(
            arr.ids, arr.tau_prime, targets, delay, history=h2)
        for i, q in enumerate(arrays.score_rows(Tc2, oq).tolist()):
            if nonzero[i]:
                consider(q, float(ms2[i]), ("lockstep", i))

        # family 3 — shared-NEW-horizon Algorithm 1 candidates
        levels3 = np.arange(1, t_new_max + 1, dtype=np.int64)
        h3: list = []
        Tc3, ms3, _, _ = arrays._clustered_rounds(
            arr.ids, arr.tau_prime, np.zeros(arr.K, dtype=np.int64),
            delay, levels3, history=h3)
        for i, q in enumerate(arrays.score_rows(Tc3, oq).tolist()):
            consider(q, float(ms3[i]), ("shared", i))

        pick = state["pick"]
        if pick is None:
            return BatchPlan(batches=[], start_times=[],
                             steps_completed={k: 0 for k in ids},
                             delay=delay)
        family, i = pick
        if family == "clustered":
            counts, hist, replay = Tc1[i], h1, arrays._replay_clustered
        elif family == "lockstep":
            counts, hist, replay = Tc2[i], h2, arrays._replay_lockstep
        else:
            counts, hist, replay = Tc3[i], h3, arrays._replay_clustered
        batches, starts = replay(arr.ids, i, hist, delay)
        steps = {int(k): int(c) for k, c in zip(arr.ids, counts)}
        return BatchPlan(batches=batches, start_times=starts,
                         steps_completed=steps, delay=delay)


stacking_offset = StackingOffset()
