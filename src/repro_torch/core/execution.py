"""Closed-loop plan execution: measure -> refit -> replan on real
wall-clock.  A copy of ``repro.core.execution``.

The planner and the executors meet only through the affine delay model
g(X) = aX + b (Eq. 4).  ``ExecutionLoop`` closes that loop: it drives a
``BatchPlan`` on a *session* (a stepwise executor handle — the real DDIM
U-Net, a ServingEngine decode stream, or the synthetic
``SimulatedSession``), one batch at a time, and

  * records per-batch ``(batch_size, wall_clock)`` telemetry,
  * refits the delay model online (rolling least squares over the last
    W batches, ``core/delay_model.py``'s ``RollingDelayFit``),
  * when the relative predicted-vs-measured batch delay drifts past a
    tolerance, replans the *residual* scenario through the same
    offset-aware path as ``_ServerTrack`` (executed steps credited as
    offsets, retired-with-progress services transmit immediately,
    no-resurrection invariants hold) and retargets the session's
    remaining schedules.

Time inside the loop is measured, not simulated: completion instants,
deadline verdicts and the reported makespan all come from the session's
wall-clock.  Transmission stays analytic (``ServiceRequest.tx_delay``
under the adopting allocation) — the radio link is not executed here.

Sessions are duck-typed (``repro_torch.api.execution`` maps executor
names to their factories in ``EXECUTORS``):

    run_batch(ids, timed=True) -> measured seconds
    retarget(totals)              # new TOTAL step counts, >= executed
    finish() -> {id: content}
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import arrays
from repro_torch.core.bandwidth import make_plan
from repro_torch.core.delay_model import DelayModel, RollingDelayFit
from repro_torch.core.online import _ServiceState, offset_aware
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.core.service import Scenario
from repro_torch.core.simulator import ServiceOutcome

_TIE = 1e-6   # deadline slack, matches core/simulator.py

#: Denoising execution engines (``repro_torch.diffusion``): ``"dict"`` is
#: the per-service-latent reference path, ``"bucketed"`` the
#: device-resident padded-bucket engine (one CUDA graph per bucket on
#: the card).
EXEC_ENGINES = ("dict", "bucketed")


def exec_engine_default() -> str:
    """Process-default execution engine for the denoising executor —
    the ``REPRO_EXEC_ENGINE`` environment variable, else ``"dict"``
    (the bit-exact-per-row reference path)."""
    return os.environ.get("REPRO_EXEC_ENGINE", "dict")


def shape_bucket(n: int) -> int:
    """Power-of-two padded batch-size bucket (min 2).

    This is the shape grid the bucketed denoising executor captures
    one gather->DDIM-step->scatter program per, and the grid
    ``ExecutionLoop`` telemetry groups measured per-batch wall-clock
    by (so drift is attributable to a kernel's batch-shape regime).
    Plans whose batches never exceed ``K_max`` services touch at most
    ``ceil(log2(K_max))`` buckets."""
    return max(2, 1 << max(0, int(n - 1).bit_length()))


class SimulatedSession:
    """Synthetic executor: per-batch wall-clock drawn from a hidden
    *true* ``DelayModel`` (optional multiplicative noise, deterministic
    per seed).  Lets the closed loop — drift detection, refit,
    replanning, crediting — be exercised in milliseconds without a
    U-Net; content is each service's final step count."""

    def __init__(self, plan: BatchPlan, true_delay: DelayModel,
                 noise: float = 0.0, seed: int = 0):
        self.true_delay = true_delay
        self.noise = float(noise)
        self._rng = np.random.default_rng(seed)
        self.steps_done: Dict[int, int] = {
            k: 0 for k in plan.steps_completed}
        self._totals: Dict[int, int] = {
            k: int(v) for k, v in plan.steps_completed.items()}

    def run_batch(self, ks, timed: bool = False) -> float:
        for k in ks:
            if self.steps_done[k] >= self._totals[k]:
                raise ValueError(
                    f"service {k} has no remaining steps")
        dt = self.true_delay.g(len(ks))
        if self.noise:
            dt = max(dt * (1.0 + self.noise *
                           float(self._rng.standard_normal())), 1e-9)
        for k in ks:
            self.steps_done[k] += 1
        return dt

    def retarget(self, totals: Dict[int, int]) -> None:
        for k, total in totals.items():
            if total < self.steps_done[k]:
                raise ValueError(
                    f"service {k}: retarget total {total} < "
                    f"{self.steps_done[k]} steps already executed")
            self._totals[k] = int(total)

    def finish(self) -> Dict[int, int]:
        return dict(self.steps_done)

    def telemetry(self) -> dict:
        return {"exec_engine": "simulated"}


@dataclasses.dataclass
class BatchRecord:
    """One executed batch: what the planning model predicted vs what the
    session measured."""
    index: int
    size: int
    predicted_s: float
    measured_s: float
    t_start: float
    t_end: float


@dataclasses.dataclass
class ExecutionResult:
    """Outcome of one ``ExecutionLoop.run``: measured-time per-service
    outcomes plus the telemetry the loop collected."""
    outcomes: List[ServiceOutcome]
    records: List[BatchRecord]
    content: Dict
    delay: DelayModel            # model in force at the end (refit)
    mean_fid: float
    outage_rate: float
    delivered_fid: float         # late content scores fid(0)
    wall_clock: float            # measured generation makespan
    replans: int
    refits: int
    mode: str
    executed_log: List[tuple]
    exec_engine: str = ""                # engine the session reported
    session_telemetry: Optional[dict] = None   # session.telemetry()

    @property
    def timings(self) -> List[tuple]:
        """(batch_size, seconds) telemetry — the shape
        ``ProvisionReport.refit_delay`` consumes."""
        return [(r.size, r.measured_s) for r in self.records]

    def per_bucket(self) -> Dict[int, dict]:
        """Measured per-batch wall-clock grouped by ``shape_bucket``:
        ``{bucket: {batches, total_s, mean_s, min_s, predicted_s}}``.
        Drift in one bucket and not another points at the kernels'
        batch-shape regime (``groupnorm_silu``'s launch plan is chosen
        per shape), not at the affine model."""
        out: Dict[int, dict] = {}
        for r in self.records:
            b = out.setdefault(shape_bucket(r.size), {
                "batches": 0, "total_s": 0.0, "min_s": float("inf"),
                "predicted_s": 0.0})
            b["batches"] += 1
            b["total_s"] += r.measured_s
            b["min_s"] = min(b["min_s"], r.measured_s)
            b["predicted_s"] += r.predicted_s
        for b in out.values():
            b["mean_s"] = b["total_s"] / b["batches"]
        return out

    def predicted_wall(self, model: Optional[DelayModel] = None) -> float:
        """Sum of g(X_n) over the executed batch sizes under ``model``
        (default: the final refit model) — compare with ``wall_clock``
        to judge how well the affine model explains this hardware."""
        m = model if model is not None else self.delay
        return float(sum(m.g(r.size) for r in self.records))

    def summary(self) -> str:
        return (f"[execution {self.mode}] batches={len(self.records)} "
                f"wall={self.wall_clock:.3f}s "
                f"predicted={self.predicted_wall():.3f}s "
                f"replans={self.replans} refits={self.refits} | "
                f"mean_fid={self.mean_fid:.3f} "
                f"delivered_fid={self.delivered_fid:.3f} "
                f"outage={self.outage_rate:.1%}")

    def to_dict(self) -> dict:
        return {
            "kind": "execution",
            "mode": self.mode,
            "mean_fid": float(self.mean_fid),
            "outage_rate": float(self.outage_rate),
            "delivered_fid": float(self.delivered_fid),
            "makespan": float(self.wall_clock),
            "replans": int(self.replans),
            "refits": int(self.refits),
            "delay": {"a": float(self.delay.a), "b": float(self.delay.b)},
            "exec_engine": self.exec_engine,
            "telemetry": {
                "batches": len(self.records),
                "timings": [[int(s), float(d)] for s, d in self.timings],
                "wall_clock": float(self.wall_clock),
                "predicted_wall": float(self.predicted_wall()),
                "per_bucket": {
                    str(b): {k: (int(v) if k == "batches" else float(v))
                             for k, v in agg.items()}
                    for b, agg in sorted(self.per_bucket().items())},
                "session": self.session_telemetry,
            },
        }


class ExecutionLoop:
    """Drive a planned batch schedule on a session, refit the delay
    model from measured wall-clock, and (in ``mode="closed"``) replan
    mid-flight when prediction drifts.

    ``mode="open"`` executes the plan as given — telemetry and the
    rolling refit still run (so ``result.delay`` reflects the hardware)
    but the schedule is never changed.  ``mode="closed"`` additionally
    replans through the offset-aware residual path whenever the mean
    relative error of the last ``min_batches`` batches exceeds
    ``drift_tol``; ``headroom`` inflates the refit model used for
    replanning so the new schedule keeps slack against timing noise.
    ``engine`` pins the planning engine of every replan
    (``repro_torch.core.arrays``); ``None`` keeps the process default.
    """

    def __init__(self, scenario: Scenario, plan: BatchPlan, alloc,
                 session, *, delay: Optional[DelayModel] = None,
                 quality: Optional[QualityModel] = None,
                 scheduler=None, allocator=None, mode: str = "closed",
                 window: int = 32, drift_tol: float = 0.25,
                 min_batches: int = 3, max_replans: int = 8,
                 headroom: float = 1.0, validate: bool = True,
                 engine: Optional[str] = None,
                 exec_engine: Optional[str] = None):
        if mode not in ("open", "closed"):
            raise ValueError(f"mode must be 'open' or 'closed', "
                             f"got {mode!r}")
        if mode == "closed" and (scheduler is None or allocator is None):
            raise ValueError("mode='closed' needs scheduler= and "
                             "allocator= to replan with")
        self.scenario = scenario
        self.session = session
        self.scheduler = scheduler
        self.allocator = allocator
        self.delay = delay if delay is not None else DelayModel()
        self.quality = quality if quality is not None else PowerLawFID()
        self.mode = mode
        self.drift_tol = float(drift_tol)
        self.min_batches = int(min_batches)
        self.max_replans = int(max_replans)
        self.headroom = float(headroom)
        self.validate = validate
        self.engine = engine
        # the denoising-session engine the session was opened with —
        # recorded for telemetry; the session itself (already built by
        # the caller) is what actually implements it
        self.exec_engine = exec_engine

        alloc = np.asarray(alloc, dtype=np.float64)
        self.alloc_map: Dict[int, float] = {
            s.id: float(alloc[i]) for i, s in enumerate(scenario.services)}
        self.states: Dict[int, _ServiceState] = {
            s.id: _ServiceState(s, admitted=True)
            for s in scenario.services}
        self.pending = {k for k, T in plan.steps_completed.items()
                        if T > 0}
        self.batches = list(plan.batches)
        self.last = self._last_batch_of(self.batches)
        self.i = 0

        self.fit = RollingDelayFit(window=window, prior=self.delay)
        self._drift: "collections.deque[float]" = collections.deque(
            maxlen=self.min_batches)
        self.records: List[BatchRecord] = []
        self.executed_log: List[tuple] = []
        self.replans = 0
        self.refits = 0

    @staticmethod
    def _last_batch_of(batches) -> Dict[int, int]:
        last: Dict[int, int] = {}
        for n, batch in enumerate(batches):
            for k, _ in batch:
                last[k] = n
        return last

    def _complete(self, st: _ServiceState, t: float,
                  bandwidth: float) -> None:
        st.gen_end = t
        st.bandwidth = bandwidth
        st.tx_dur = st.svc.tx_delay(bandwidth, self.scenario.content_bits)
        st.tx_end = t + st.tx_dur
        self.pending.discard(st.svc.id)

    # -- the loop ---------------------------------------------------------

    def run(self) -> ExecutionResult:
        t = 0.0
        while self.i < len(self.batches):
            ks = [k for k, _ in self.batches[self.i]]
            predicted = self.delay.g(len(ks))
            with obs.span("loop.batch", size=len(ks),
                          predicted_s=predicted) as sp:
                dt = float(self.session.run_batch(ks, timed=True))
                sp.set(measured_s=dt)
                t_end = t + dt
                for k in ks:
                    st = self.states[k]
                    st.steps_done += 1
                    self.executed_log.append((t, k, st.steps_done))
                self.records.append(BatchRecord(
                    index=len(self.records), size=len(ks),
                    predicted_s=predicted, measured_s=dt,
                    t_start=t, t_end=t_end))
                for k in ks:
                    if self.last.get(k) == self.i:
                        self._complete(self.states[k], t_end,
                                       self.alloc_map[k])
                self.fit.observe(len(ks), dt)
                self._drift.append(abs(dt - predicted) /
                                   max(predicted, 1e-12))
            t = t_end
            self.i += 1
            if (self.mode == "closed" and self.pending
                    and self.i < len(self.batches)
                    and len(self._drift) >= self.min_batches
                    and self.replans < self.max_replans
                    and float(np.mean(self._drift)) > self.drift_tol):
                with obs.span("loop.replan", batches=len(self.records)):
                    self._replan(t)
        return self._finalize(t)

    def _replan(self, t: float) -> None:
        """Refit from the telemetry window, replan the residual scenario
        (executed steps as offsets — exactly the ``_ServerTrack``
        crediting), adopt it, and retarget the session."""
        self.delay = self.fit.model(headroom=self.headroom)
        self.refits += 1
        scn = self.scenario
        residual = [
            dataclasses.replace(
                self.states[s.id].svc,
                deadline=self.states[s.id].abs_deadline - t,
                arrival=0.0)
            for s in scn.services if s.id in self.pending]
        B = scn.total_bandwidth_hz
        reserved = sum(st.bandwidth for st in self.states.values()
                       if st.gen_complete and st.tx_end > t)
        res_scn = Scenario(services=residual,
                           total_bandwidth_hz=max(B - reserved,
                                                  1e-6 * B),
                           content_bits=scn.content_bits)
        offsets = [self.states[s.id].steps_done
                   for s in res_scn.services]
        scheduler, quality = offset_aware(self.scheduler, self.quality,
                                          offsets)
        with arrays.engine_scope(self.engine):
            alloc = np.asarray(self.allocator(
                res_scn, scheduler, self.delay, quality))
            tp, plan = make_plan(res_scn, alloc, scheduler, self.delay,
                                 quality)
        if self.validate:
            plan.validate(gen_deadlines=tp)
        self.replans += 1

        self.alloc_map.update(
            {s.id: float(alloc[j])
             for j, s in enumerate(res_scn.services)})
        self.batches = list(plan.batches)
        self.last = self._last_batch_of(self.batches)
        self.i = 0
        self._drift.clear()
        # a partially-generated service the new plan gives no further
        # steps is done denoising: transmit what it has, now
        for k in sorted(self.pending):
            st = self.states[k]
            if st.steps_done > 0 and \
                    plan.steps_completed.get(k, 0) == 0:
                self._complete(st, t, self.alloc_map[k])
        self.session.retarget(
            {s.id: self.states[s.id].steps_done +
             int(plan.steps_completed.get(s.id, 0))
             for s in res_scn.services})

    def _finalize(self, t: float) -> ExecutionResult:
        # defensively settle any straggler with banked steps (cannot
        # happen when every plan runs to completion, but cheap to hold)
        for k in sorted(self.pending):
            st = self.states[k]
            if st.steps_done > 0 and not st.gen_complete:
                self._complete(st, t, self.alloc_map[k])
        with obs.span("session.finish"):
            content = self.session.finish()
        if self.fit.ready:
            # final refit from the telemetry window, in both modes —
            # result.delay always reflects the measured hardware
            self.delay = self.fit.model()
            self.refits += 1
        outcomes = []
        for s in self.scenario.services:
            st = self.states[s.id]
            T = st.steps_done
            if st.gen_complete:
                gen = st.gen_end - s.arrival
                tx = st.tx_dur
                e2e = gen + tx
                met = T > 0 and e2e <= s.deadline + _TIE
            else:
                gen = tx = e2e = 0.0
                met = False
            outcomes.append(ServiceOutcome(
                id=s.id, deadline=s.deadline, steps=T, gen_delay=gen,
                tx_delay=tx, e2e_delay=e2e, fid=self.quality.fid(T),
                met_deadline=met))
        mean_fid = float(np.mean([o.fid for o in outcomes])) \
            if outcomes else float("nan")
        outage = float(np.mean([0.0 if o.met_deadline else 1.0
                                for o in outcomes])) if outcomes else 0.0
        fid0 = self.quality.fid(0)
        delivered = float(np.mean(
            [o.fid if o.met_deadline else fid0 for o in outcomes])) \
            if outcomes else float("nan")
        tele_fn = getattr(self.session, "telemetry", None)
        session_tele = tele_fn() if callable(tele_fn) else None
        exec_engine = self.exec_engine or \
            (session_tele or {}).get("exec_engine", "")
        return ExecutionResult(
            outcomes=outcomes, records=self.records, content=content,
            delay=self.delay, mean_fid=mean_fid, outage_rate=outage,
            delivered_fid=delivered, wall_clock=t, replans=self.replans,
            refits=self.refits, mode=self.mode,
            executed_log=self.executed_log, exec_engine=exec_engine,
            session_telemetry=session_tele)
