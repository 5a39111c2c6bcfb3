"""The measured window: closed-loop provisioning rounds, and the spans
the harness records around its calls into each layer of the program.

Each round draws K requests (``traffic.round_requests``), hands them to
``repro_torch.api.Provisioner(...).run(execute="closed")`` with the
cell's workload instance, allocator and scheduler, and waits for it to
return.  The allocator and the scheduler are the program's registered
callables, wrapped to time and record every call (the first plan and
each replan); the workload is wrapped so that each batch the execution
loop runs, and each retarget, is timed and logged on the host clock
(``run_batch(timed=True)`` ends in a device synchronize).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from harness import frozen
from harness.traffic import Request


@dataclasses.dataclass
class PlanCall:
    kind: str                   # "allocate" or "schedule"
    t0: float
    t1: float
    ids: List[int]
    inputs: Dict[str, Any]
    output: Any
    n_batches: int              # session batches run before the call


@dataclasses.dataclass
class RoundLog:
    r: int
    requests: List[Request]
    t0: float = 0.0
    t1: float = 0.0
    calls: List[PlanCall] = dataclasses.field(default_factory=list)
    # session events in order: ("batch", ids) or ("retarget", totals)
    events: List[tuple] = dataclasses.field(default_factory=list)
    # (ids, t0, t1, seconds the program measured) per batch
    batches: List[tuple] = dataclasses.field(default_factory=list)
    initial_totals: Dict[int, int] = dataclasses.field(default_factory=dict)
    records: List[Tuple[int, float, float]] = dataclasses.field(
        default_factory=list)       # (size, predicted_s, measured_s)
    executed_log: List[tuple] = dataclasses.field(default_factory=list)
    content: Dict[int, Any] = dataclasses.field(default_factory=dict)
    content_bits: float = 0.0

    def schedule_calls(self) -> List[PlanCall]:
        return [c for c in self.calls if c.kind == "schedule"]


class _Timed:
    """A planner callable that records each call's inputs, output and
    host seconds into the current round's log."""

    def __init__(self, fn, kind: str, name: str):
        self.fn, self.kind, self.__name__ = fn, kind, name
        self.log: Optional[RoundLog] = None

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        t1 = time.perf_counter()
        if self.kind == "allocate":
            scn = args[0]
            ids = [s.id for s in scn.services]
            inputs = {"eta": [s.spectral_eff for s in scn.services],
                      "total_hz": scn.total_bandwidth_hz}
            output = np.asarray(out, dtype=np.float64).copy()
        else:
            services, taup, delay = args[0], args[1], args[2]
            ids = [s.id for s in services]
            inputs = {"tau_prime": {k: float(taup[k]) for k in ids},
                      "a": float(delay.a), "b": float(delay.b)}
            output = ([[int(k) for k, _ in b] for b in out.batches],
                      {int(k): int(v) for k, v in
                       out.steps_completed.items()})
        self.log.calls.append(PlanCall(self.kind, t0, t1, ids, inputs,
                                       output, len(self.log.batches)))
        return out


class _Session:
    def __init__(self, inner, log: RoundLog):
        self.inner, self.log = inner, log

    def run_batch(self, ks, timed: bool = False) -> float:
        t0 = time.perf_counter()
        dt = self.inner.run_batch(ks, timed=timed)
        t1 = time.perf_counter()
        ids = tuple(int(k) for k in ks)
        self.log.events.append(("batch", ids))
        self.log.batches.append((ids, t0, t1, float(dt)))
        return dt

    def retarget(self, totals) -> None:
        self.log.events.append(
            ("retarget", {int(k): int(v) for k, v in totals.items()}))
        self.inner.retarget(totals)

    def finish(self):
        return self.inner.finish()

    def telemetry(self):
        fn = getattr(self.inner, "telemetry", None)
        return fn() if callable(fn) else None


class _Workload:
    """The cell's workload instance, its sessions logged."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.log: Optional[RoundLog] = None

    def open_session(self, plan, generator=None, **kw):
        self.log.initial_totals = {int(k): int(v) for k, v in
                                   plan.steps_completed.items()}
        return _Session(self.inner.open_session(plan, generator, **kw),
                        self.log)


class Rounds:
    """Runs rounds against one driver (a configuration's system)."""

    def __init__(self, driver, traffic: dict):
        from repro_torch.api import ALLOCATORS, SCHEDULERS, Provisioner
        self.Provisioner = Provisioner
        self.driver, self.traffic = driver, traffic
        self.alloc = _Timed(ALLOCATORS.get(traffic["allocator"]),
                            "allocate", traffic["allocator"])
        self.sched = _Timed(SCHEDULERS.get(traffic["scheduler"]),
                            "schedule", traffic["scheduler"])
        self.workload = _Workload(driver.workload)

    def run(self, r: int, requests: List[Request]) -> RoundLog:
        from repro_torch.core.service import Scenario, ServiceRequest
        log = RoundLog(r=r, requests=requests,
                       content_bits=float(self.traffic["content_bits"]))
        self.alloc.log = self.sched.log = self.workload.log = log
        scn = Scenario(
            services=[ServiceRequest(id=q.id, deadline=q.deadline,
                                     spectral_eff=q.spectral_eff)
                      for q in requests],
            total_bandwidth_hz=float(self.traffic["total_bandwidth_hz"]),
            content_bits=float(self.traffic["content_bits"]))
        run_kw = self.driver.round_inputs(log)
        log.t0 = time.perf_counter()
        report = self.Provisioner(
            scn, workload=self.workload, scheduler=self.sched,
            allocator=self.alloc, delay=self.driver.delay,
            quality=self.driver.quality, device=self.driver.device,
            execute_kwargs=self.driver.execute_kwargs).run(
                execute="closed", **run_kw)
        log.t1 = time.perf_counter()
        ex = report.execution
        log.records = [(r_.size, r_.predicted_s, r_.measured_s)
                       for r_ in ex.records]
        log.executed_log = list(ex.executed_log)
        log.content = ex.content
        return log


def outcomes(log: RoundLog, traffic: dict, quality) -> List[dict]:
    """Each request of a round as its user saw it: steps received,
    end-to-end delay on the harness clock from the round's start to the
    end of the request's last batch, plus the analytic transmission
    delay under the allocation in force when it completed (the last
    allocation that covered it), and whether that met its deadline.  A
    request that received no step is late, its delay the round's length
    plus its transmission."""
    steps: Dict[int, int] = {}
    last_end: Dict[int, float] = {}
    for ids, _, t1, _ in log.batches:
        for k in ids:
            steps[k] = steps.get(k, 0) + 1
            last_end[k] = t1
    band: Dict[int, float] = {}
    for c in log.calls:
        if c.kind == "allocate":
            band.update(zip(c.ids, (float(b) for b in c.output)))
    bits = float(traffic["content_bits"])
    out = []
    for q in log.requests:
        tx = frozen.tx_delay(bits, band[q.id], q.spectral_eff)
        T = steps.get(q.id, 0)
        if T > 0:
            delay = last_end[q.id] - log.t0 + tx
            met = delay <= q.deadline + 1e-6
        else:
            delay = log.t1 - log.t0 + tx
            met = False
        out.append({"id": q.id, "steps": T, "delay": delay,
                    "deadline": q.deadline, "met": met,
                    "fid": quality.fid(T) if met else quality.fid(0)})
    return out
