"""Event-driven online admission simulator, a copy of
``repro.core.online``.

The paper provisions a *static* batch: all K requests are known at t=0,
one bandwidth allocation (P1) and one batch-denoising plan (P2) serve
them all.  ``simulate_online`` relaxes exactly one assumption, that
requests arrive over time (``ServiceRequest.arrival``), and replays the
paper's pipeline as an event loop:

  arrival(k)   -> admission decision (pluggable policy, given a *trial*
                  replan that includes k) -> on admit, adopt the trial
                  plan; on reject, keep the current plan untouched
  batch start  -> the batch is committed ("in-flight"): a later arrival
                  can replan everything scheduled after it, but never
                  preempt it
  generation   -> the service's last scheduled batch completes; its
                  content transmits over the bandwidth the adopting
                  replan gave it

Replanning semantics (the residual scenario):

  * remaining end-to-end budget of a live service is its absolute
    deadline minus the replan instant (deadlines shrink as time passes);
  * denoising steps already executed are kept: the replanned batches
    schedule *additional* steps and final quality is ``fid(done + new)``;
  * the scheduler's outer search scores plans with the unshifted
    quality model ("progress-agnostic" objective); the executed steps
    still count toward the reported outcome.  With every arrival at t=0
    there is nothing in flight, so the online path reproduces the static
    ``simulate`` bit-for-bit.

The loop is pure numpy + stdlib and deterministic.  The per-server half
of the loop (active plan, batch execution, residual replanning) lives in
``_ServerTrack``; ``OnlineSimulation`` is the single-track instance.
``_offset_native``, ``_ServiceState``, ``_OffsetQuality`` and
``offset_aware`` also serve ``core/execution.py``'s closed loop.
tests/test_torch_execution.py holds its results equal (``==``) to the
reference's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Set

import numpy as np

from repro_torch.core import arrays
from repro_torch.core.bandwidth import make_plan
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.core.service import Scenario, ServiceRequest
from repro_torch.core.simulator import ServiceOutcome

# (residual_scenario, scheduler, delay, quality) -> B_k array: the
# calling convention of the allocators in repro_torch.api.provisioner.
AllocatorFn = Callable[..., np.ndarray]
# (svc, projected ServiceOutcome, {id: _ServiceState}) -> admit?
AdmissionFn = Callable[..., bool]

_TIE = 1e-6   # deadline slack, matches core/simulator.py


def _offset_native(scheduler) -> bool:
    """Does this scheduler implement the ``OffsetScheduler`` extension
    (a ``plan(services, tau_prime, delay, quality, offsets)`` method
    plus the ``supports_offsets`` marker)?  The explicit marker keeps a
    custom scheduler's unrelated ``plan`` helper from being mistaken
    for the protocol; duck-typed so the core never imports the api."""
    return bool(getattr(scheduler, "supports_offsets", False)) \
        and callable(getattr(scheduler, "plan", None))


@dataclasses.dataclass
class AdmissionDecision:
    """One arrival's verdict, with the outcome the trial replan projected
    for it (what the admission policy saw)."""
    id: int
    arrival: float
    admitted: bool
    projected: ServiceOutcome


@dataclasses.dataclass
class OnlineResult:
    """Per-service outcomes for admitted requests (scenario order) plus
    the arrival-ordered admission log.  Delays are relative to each
    service's arrival, so at ``arrival == 0`` for all services the
    outcomes equal the static ``simulate`` result."""
    outcomes: List[ServiceOutcome]
    decisions: List[AdmissionDecision]
    mean_fid: float          # over admitted services
    outage_rate: float       # over admitted services
    reject_rate: float       # rejected / all arrivals
    # committed batch sequence as (start_time, [ids]): what actually
    # ran, across every adopted replan.  Populated by the single-track
    # simulator; api/execution.py's replay_result replays it on a real
    # executor.
    executed_batches: Optional[List] = None

    @property
    def admitted_ids(self) -> List[int]:
        return [o.id for o in self.outcomes]

    @property
    def rejected_ids(self) -> List[int]:
        return [d.id for d in self.decisions if not d.admitted]

    def summary(self) -> str:
        lines = [f"{'svc':>4} {'arr':>7} {'tau':>7} {'steps':>6} "
                 f"{'gen':>8} {'tx':>7} {'e2e':>8} {'fid':>8} ok"]
        arr = {d.id: d.arrival for d in self.decisions}
        for o in self.outcomes:
            lines.append(
                f"{o.id:>4} {arr.get(o.id, 0.0):7.2f} {o.deadline:7.2f} "
                f"{o.steps:6d} {o.gen_delay:8.3f} {o.tx_delay:7.3f} "
                f"{o.e2e_delay:8.3f} {o.fid:8.2f} "
                f"{'Y' if o.met_deadline else 'N'}")
        lines.append(
            f"admitted {len(self.outcomes)}/{len(self.decisions)}  "
            f"mean FID {self.mean_fid:.3f}  outage {self.outage_rate:.1%}  "
            f"reject {self.reject_rate:.1%}")
        return "\n".join(lines)


@dataclasses.dataclass
class _ServiceState:
    svc: ServiceRequest
    admitted: Optional[bool] = None     # None until its arrival is processed
    steps_done: int = 0
    gen_end: Optional[float] = None     # absolute generation-complete time
    tx_dur: float = 0.0                 # D_k^ct under the adopted bandwidth
    tx_end: Optional[float] = None
    bandwidth: float = 0.0              # B_k of the plan that finished it

    @property
    def abs_deadline(self) -> float:
        return self.svc.arrival + self.svc.deadline

    @property
    def gen_complete(self) -> bool:
        return self.gen_end is not None


class _OffsetQuality:
    """Progress-aware replanning objective.

    A replan schedules *additional* steps, but quality is a function of
    the running total, so a candidate step-count vector is scored as
    ``fid(done_k + new_k)``.  The Scheduler protocol evaluates anonymous
    count lists; by the ``make_plan`` convention those are in residual
    service order (stacking, equal_steps, single_instance and the P1
    ``evaluate`` fitness all comply), which is how ``offsets`` is keyed.
    A scheduler scoring a differently-ordered or partial list silently
    degrades to the progress-agnostic base objective, never crashes.
    Per-step ``fid`` stays unshifted (only ``optimal`` uses it, as a
    symmetric DP value).

    ``doomed`` closes an exploit: a partially-generated service whose
    residual generation budget went *negative* (its transmission alone
    overruns the deadline under the candidate bandwidth allocation) can
    never deliver on time, so its banked steps are worth ``fid(0)`` —
    otherwise allocators learn to strip bandwidth from nearly-finished
    services "for free" and their content arrives late.  The set is
    refreshed per scheduler invocation (it depends on the candidate
    allocation via tau'), matching the static objective where an
    infeasible service scores ``fid_at_zero``.
    """

    def __init__(self, base: QualityModel, offsets: List[int]):
        self.base = base
        self.offsets = offsets
        self.doomed: Set[int] = set()

    def refresh_doomed(self, services, tau_prime: Dict[int, float]) -> None:
        self.doomed = {i for i, s in enumerate(services)
                       if self.offsets[i] > 0 and tau_prime[s.id] < 0}

    def fid(self, steps: int) -> float:
        return self.base.fid(steps)

    def mean_fid(self, step_counts) -> float:
        if len(step_counts) != len(self.offsets):
            return float(np.mean([self.base.fid(t) for t in step_counts]))
        return float(np.mean([
            self.base.fid(0) if i in self.doomed
            else self.base.fid(self.offsets[i] + t)
            for i, t in enumerate(step_counts)]))


def offset_aware(scheduler, quality: QualityModel, offsets: List[int]):
    """Wrap ``(scheduler, quality)`` for a replan over services with
    already-executed steps (``offsets``, residual scenario order).

    With no executed steps the pair passes through unchanged.  Otherwise
    the quality model becomes the progress-aware ``_OffsetQuality`` and
    the scheduler is wrapped so every invocation first refreshes the
    doomed set for the candidate allocation's tau'; offset-native
    schedulers (``OffsetScheduler`` protocol) are dispatched through
    their ``plan(..., offsets)`` entry with the *base* quality model.
    Shared by ``_ServerTrack.replan`` and ``core.execution`` so both
    replan paths credit executed steps identically.
    """
    if not any(offsets):
        return scheduler, quality
    oq = _OffsetQuality(quality, offsets)

    if _offset_native(scheduler):
        # offset-native dispatch: the scheduler plans against
        # per-service progress itself (base quality model + offsets);
        # the _OffsetQuality wrapper still scores the allocator's
        # fitness evaluations so P1 stays progress-aware too
        def wrapped(services, tau_prime, delay, q,
                    _inner=scheduler, _oq=oq, _base=quality,
                    _off=offsets):
            _oq.refresh_doomed(services, tau_prime)
            return _inner.plan(services, tau_prime, delay, _base, _off)
    else:
        def wrapped(services, tau_prime, delay, q,
                    _inner=scheduler, _oq=oq):
            # every candidate allocation implies fresh tau' — mark
            # which in-progress services it starves before the inner
            # scheduler's own mean_fid evaluations run
            _oq.refresh_doomed(services, tau_prime)
            return _inner(services, tau_prime, delay, q)

    return wrapped, oq


@dataclasses.dataclass
class _ActivePlan:
    """An adopted replan: a BatchPlan anchored at absolute time ``t0``."""
    t0: float
    plan: BatchPlan
    alloc: Dict[int, float]             # id -> Hz under this plan
    last_batch_of: Dict[int, int]       # id -> index of its final batch
    next_batch: int = 0


def _anchor(t0: float, plan: BatchPlan, res_scn: Scenario,
            alloc: np.ndarray) -> _ActivePlan:
    last: Dict[int, int] = {}
    for n, batch in enumerate(plan.batches):
        for k, _ in batch:
            last[k] = n
    return _ActivePlan(
        t0=t0, plan=plan,
        alloc={s.id: float(alloc[i]) for i, s in enumerate(res_scn.services)},
        last_batch_of=last)


class _ServerTrack:
    """The per-server half of the event loop: one server's active plan,
    batch execution, and residual replanning.

    ``states`` is the simulation-wide state dict (each service only ever
    lives on one track, recorded in ``owned``).  ``bandwidth_hz`` is this cell's own budget
    and ``delay`` the delay model as seen on this server's hardware.
    """

    def __init__(self, scn: Scenario, bandwidth_hz: float, scheduler,
                 allocator: AllocatorFn, delay: DelayModel,
                 quality: QualityModel, states: Dict[int, _ServiceState],
                 validate: bool = True):
        self.scn = scn
        self.bandwidth_hz = bandwidth_hz
        self.scheduler = scheduler
        self.allocator = allocator
        self.delay = delay
        self.quality = quality
        self.states = states
        self.validate = validate

        # every id admitted here; drives the reserved-bandwidth filter
        # in residual_scenario
        self.owned: Set[int] = set()
        self.pending: Set[int] = set()      # admitted, generation incomplete
        self.active: Optional[_ActivePlan] = None
        self.t_free = 0.0
        self.replan_count = 0
        # (t_start, service, cumulative step count) per executed task —
        # the replan-invariant tests read this (steps must be contiguous)
        self.executed_log: List[tuple] = []

    # -- event handlers --------------------------------------------------

    def _complete_generation(self, st: _ServiceState, t: float,
                             bandwidth: float) -> None:
        st.gen_end = t
        st.bandwidth = bandwidth
        st.tx_dur = st.svc.tx_delay(bandwidth, self.scn.content_bits)
        st.tx_end = t + st.tx_dur
        self.pending.discard(st.svc.id)

    def execute_until(self, t_limit: float) -> None:
        """Run every batch whose start time precedes ``t_limit``.

        A batch is committed atomically at its start instant: once
        started it always finishes (the "in-flight batch pinned" rule),
        so its end may land past ``t_limit``.  A batch starting exactly
        at an arrival instant has not started yet and stays replannable.
        """
        ap = self.active
        if ap is None:
            return
        starts, batches = ap.plan.start_times, ap.plan.batches
        while ap.next_batch < len(batches) and \
                ap.t0 + starts[ap.next_batch] < t_limit:
            n = ap.next_batch
            batch = batches[n]
            end = ap.t0 + starts[n] + ap.plan.delay.g(len(batch))
            for k, _ in batch:
                st = self.states[k]
                st.steps_done += 1
                self.executed_log.append(
                    (ap.t0 + starts[n], k, st.steps_done))
                if n == ap.last_batch_of[k]:
                    self._complete_generation(st, end, ap.alloc[k])
            self.t_free = max(self.t_free, end)
            ap.next_batch += 1

    def residual_scenario(self, ids: Set[int], t_free: float) -> Scenario:
        """Live services with deadlines shrunk to the replan instant
        (kept in scenario order so an all-at-t=0 replan sees exactly the
        static scenario).

        The bandwidth budget is only what is *uncommitted*: services
        whose content is still in the air at ``t_free`` keep the
        sub-band their adopting plan gave them, so the instantaneous sum
        over concurrent transmissions never exceeds this cell's channel
        (inductively: each replan hands out at most the remainder).
        With no arrivals after t=0 nothing is ever in flight at replan
        time and the full budget is allocated, as in the static paper
        setting."""
        residual = [
            dataclasses.replace(
                self.states[s.id].svc,
                deadline=self.states[s.id].abs_deadline - t_free,
                arrival=0.0)
            for s in self.scn.services if s.id in ids
        ]
        B = self.bandwidth_hz
        reserved = sum(st.bandwidth for st in self.states.values()
                       if st.svc.id in self.owned and st.gen_complete
                       and st.tx_end > t_free)
        return Scenario(services=residual,
                        total_bandwidth_hz=max(B - reserved, 1e-6 * B),
                        content_bits=self.scn.content_bits)

    def replan(self, ids: Set[int], t_free: float) -> _ActivePlan:
        """Allocate -> plan over the residual scenario, anchored at
        ``t_free`` (the instant this server frees up)."""
        res_scn = self.residual_scenario(ids, t_free)
        offsets = [self.states[s.id].steps_done for s in res_scn.services]
        scheduler, quality = offset_aware(self.scheduler, self.quality,
                                          offsets)
        alloc = np.asarray(self.allocator(
            res_scn, scheduler, self.delay, quality))
        tp, plan = make_plan(res_scn, alloc, scheduler, self.delay,
                             quality)
        if self.validate:
            plan.validate(gen_deadlines=tp)
        self.replan_count += 1
        return _anchor(t_free, plan, res_scn, alloc)

    def adopt(self, svc_id: int, trial: _ActivePlan) -> None:
        """Accept an arrival: the trial plan replaces this track's
        not-yet-started batches."""
        self.owned.add(svc_id)
        self.pending.add(svc_id)
        self.active = trial
        self._settle_no_step_services(trial)

    def _settle_no_step_services(self, ap: _ActivePlan) -> None:
        """A partially-generated service the new plan gives no further
        steps is done denoising: transmit what it has, now."""
        for k in sorted(self.pending):
            st = self.states[k]
            if st.steps_done > 0 and ap.plan.steps_completed.get(k, 0) == 0:
                self._complete_generation(st, ap.t0, ap.alloc[k])


def _project(svc: ServiceRequest, trial: _ActivePlan,
             quality: QualityModel, content_bits: float) -> ServiceOutcome:
    """The outcome ``svc`` gets if the trial plan runs uninterrupted —
    the evidence handed to the admission policy."""
    T = trial.plan.steps_completed.get(svc.id, 0)
    if T > 0:
        gen_abs = trial.t0 + trial.plan.completion_time(svc.id)
        gen = gen_abs - svc.arrival
        tx = svc.tx_delay(trial.alloc[svc.id], content_bits)
    else:
        gen = tx = 0.0
    e2e = gen + tx
    return ServiceOutcome(
        id=svc.id, deadline=svc.deadline, steps=T, gen_delay=gen,
        tx_delay=tx, e2e_delay=e2e, fid=quality.fid(T),
        met_deadline=(T > 0 and e2e <= svc.deadline + _TIE))


def batches_from_log(executed_log: List[tuple]) -> List[tuple]:
    """Reconstruct the committed batch sequence from a track's
    ``executed_log``: consecutive entries sharing a start instant are
    one batch (starts strictly increase across batches — each batch
    ends, and any replan anchors, after its own start)."""
    batches: List[tuple] = []
    for t_start, k, _ in executed_log:
        if batches and batches[-1][0] == t_start:
            batches[-1][1].append(k)
        else:
            batches.append((t_start, [k]))
    return batches


def _collect_result(scn: Scenario, states: Dict[int, _ServiceState],
                    decisions: List[AdmissionDecision],
                    quality: QualityModel) -> OnlineResult:
    """Final per-service outcomes + aggregates."""
    outcomes = []
    for s in scn.services:
        st = states[s.id]
        if not st.admitted:
            continue
        T = st.steps_done
        if st.gen_complete:
            gen = st.gen_end - s.arrival
            tx = st.tx_dur
            e2e = gen + tx
            met = T > 0 and e2e <= s.deadline + _TIE
        else:
            # never scheduled a single step (infeasible throughout):
            # mirrors the static simulator's T == 0 outage row
            gen = tx = e2e = 0.0
            met = False
        outcomes.append(ServiceOutcome(
            id=s.id, deadline=s.deadline, steps=T, gen_delay=gen,
            tx_delay=tx, e2e_delay=e2e, fid=quality.fid(T),
            met_deadline=met))
    mean_fid = float(np.mean([o.fid for o in outcomes])) \
        if outcomes else float("nan")
    outage = float(np.mean([0.0 if o.met_deadline else 1.0
                            for o in outcomes])) if outcomes else 0.0
    n = len(decisions)
    rejected = sum(1 for d in decisions if not d.admitted)
    return OnlineResult(outcomes=outcomes, decisions=decisions,
                        mean_fid=mean_fid, outage_rate=outage,
                        reject_rate=rejected / n if n else 0.0)


class OnlineSimulation:
    """One event-driven run; ``simulate_online`` is the functional entry.
    A single ``_ServerTrack`` covering the whole scenario."""

    def __init__(self, scn: Scenario, scheduler, allocator: AllocatorFn,
                 delay: DelayModel, quality: QualityModel,
                 admission: AdmissionFn, validate: bool = True):
        self.scn = scn
        self.scheduler = scheduler
        self.allocator = allocator
        self.delay = delay
        self.quality = quality
        self.admission = admission
        self.validate = validate

        self.states: Dict[int, _ServiceState] = {
            s.id: _ServiceState(s) for s in scn.services}
        self.track = _ServerTrack(scn, scn.total_bandwidth_hz, scheduler,
                                  allocator, delay, quality, self.states,
                                  validate=validate)
        self.decisions: List[AdmissionDecision] = []

    # back-compat views onto the single track
    @property
    def pending(self) -> Set[int]:
        return self.track.pending

    @property
    def active(self) -> Optional[_ActivePlan]:
        return self.track.active

    @property
    def t_server_free(self) -> float:
        return self.track.t_free

    @property
    def replan_count(self) -> int:
        return self.track.replan_count

    # -- main loop -------------------------------------------------------

    def run(self) -> OnlineResult:
        tr = self.track
        for svc in sorted(self.scn.services,
                          key=lambda s: (s.arrival, s.id)):
            tr.execute_until(svc.arrival)
            t_free = max(svc.arrival, tr.t_free)
            trial = tr.replan(tr.pending | {svc.id}, t_free)
            projected = _project(svc, trial, self.quality,
                                 self.scn.content_bits)
            admit = bool(self.admission(svc, projected, self.states))
            self.states[svc.id].admitted = admit
            self.decisions.append(AdmissionDecision(
                id=svc.id, arrival=svc.arrival, admitted=admit,
                projected=projected))
            if admit:
                tr.adopt(svc.id, trial)
            # on reject the current plan keeps running untouched
        tr.execute_until(math.inf)
        result = _collect_result(self.scn, self.states, self.decisions,
                                 self.quality)
        result.executed_batches = batches_from_log(tr.executed_log)
        return result


def simulate_online(scn: Scenario, scheduler, allocator: AllocatorFn,
                    delay: Optional[DelayModel] = None,
                    quality: Optional[QualityModel] = None,
                    admission: Optional[AdmissionFn] = None,
                    validate: bool = True,
                    engine: Optional[str] = None) -> OnlineResult:
    """Event-driven arrivals + on-arrival replanning (module docstring).

    scheduler / allocator are plain callables with the signatures of
    ``repro_torch.api.provisioner``'s ``SCHEDULERS`` and ``ALLOCATORS``.
    ``admission`` defaults to admit-all.  ``engine`` pins the planning
    engine (``"vec"``/``"scalar"``/``"torch"``, ``repro_torch.core.
    arrays``) for every replan of this run; ``None`` keeps the process
    default.
    """
    if admission is None:
        admission = lambda svc, projected, states: True   # noqa: E731
    sim = OnlineSimulation(scn, scheduler, allocator,
                           delay if delay is not None else DelayModel(),
                           quality if quality is not None else PowerLawFID(),
                           admission, validate=validate)
    with arrays.engine_scope(engine):
        return sim.run()
