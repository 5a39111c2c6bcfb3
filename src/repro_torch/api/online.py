"""Online admission front end: arrivals over time, a replan on each.

    from repro_torch.api import OnlineProvisioner
    from repro_torch.core.service import make_scenario

    scn = make_scenario(K=12, arrival_rate=0.2, seed=0)
    report = OnlineProvisioner(scn, scheduler="stacking",
                               allocator="inv_se",
                               admission="deadline_feasible").run()
    print(report.summary())

``OnlineProvisioner`` is the online sibling of ``Provisioner``: the same
schedulers and allocators by name, plus *admission policies* deciding
accept/reject per arrival.  Each arrival triggers a trial replan
(allocate -> plan over the residual scenario, ``core/online.py``); the
policy sees the outcome that replan projects for the newcomer and every
prior in-flight state.  ``ADMISSIONS`` names the built-in policies,
with the reference's aliases:

  * ``admit_all`` / ``all``  -- accept everything (with all arrivals at
                                t=0 this is the static pipeline exactly)
  * ``deadline_feasible`` / ``feasible``
                             -- accept iff the trial plan completes the
                                newcomer within its deadline
  * ``fid_threshold``        -- accept iff the projected FID clears a
                                bar (default 50.0; ``admission_kwargs``)

A policy may also be passed as a callable
``(svc, projected, states) -> bool``.  The port of ``repro.api.online``;
its registry is a plain dict here, as ``SCHEDULERS`` and ``ALLOCATORS``
are.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.api.base import (BaseProvisioner, display_name,
                                  report_dict, resolve)
from repro_torch.api.execution import replay_result, with_kwargs
from repro_torch.api.provisioner import (ALLOCATORS, SCHEDULERS,
                                         make_workload)
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.online import OnlineResult, simulate_online
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.core.service import Scenario, ServiceRequest
from repro_torch.core.simulator import ServiceOutcome


# -- admission policies ---------------------------------------------------

def admit_all(svc: ServiceRequest, projected: ServiceOutcome,
              states: Dict) -> bool:
    return True


def deadline_feasible(svc: ServiceRequest, projected: ServiceOutcome,
                      states: Dict) -> bool:
    return projected.steps > 0 and projected.met_deadline


def fid_threshold(svc: ServiceRequest, projected: ServiceOutcome,
                  states: Dict, *, threshold: float = 50.0) -> bool:
    return projected.steps > 0 and projected.fid <= threshold


#: admission policy name -> callable; aliases map to the same object
ADMISSIONS = {"admit_all": admit_all, "all": admit_all,
              "deadline_feasible": deadline_feasible,
              "feasible": deadline_feasible,
              "fid_threshold": fid_threshold}


# -- report + facade ------------------------------------------------------

@dataclasses.dataclass
class OnlineReport:
    """Everything one online run produced (summary mirrors
    ``ProvisionReport.summary`` with an admission column)."""
    scenario: Scenario
    result: OnlineResult
    delay: DelayModel
    quality: QualityModel
    scheduler_name: str = ""
    allocator_name: str = ""
    admission_name: str = ""
    content: Optional[Dict[int, Any]] = None  # execute=True replay output
    timings: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)                 # measured (batch_size, s)

    @property
    def mean_fid(self) -> float:
        return self.result.mean_fid

    @property
    def outage_rate(self) -> float:
        return self.result.outage_rate

    @property
    def reject_rate(self) -> float:
        return self.result.reject_rate

    def makespan(self) -> Optional[float]:
        """Absolute completion time of the last admitted service (e2e
        delays are arrival-relative)."""
        arrival = {s.id: s.arrival for s in self.scenario.services}
        times = [arrival[o.id] + o.e2e_delay for o in self.result.outcomes
                 if o.steps > 0]
        return max(times) if times else None

    def summary(self) -> str:
        head = (f"[online] scheduler={self.scheduler_name} "
                f"allocator={self.allocator_name} "
                f"admission={self.admission_name}")
        return head + "\n" + self.result.summary()

    def to_dict(self) -> dict:
        """Common report protocol (``api/base.py``'s ``report_dict``)."""
        nb = len(self.result.executed_batches or [])
        return report_dict(
            "online", mean_fid=self.mean_fid,
            outage_rate=self.outage_rate, makespan=self.makespan(),
            components={"scheduler": self.scheduler_name,
                        "allocator": self.allocator_name,
                        "admission": self.admission_name},
            telemetry={"batches": nb,
                       "timings": [[int(x), float(s)]
                                   for x, s in self.timings]},
            reject_rate=self.reject_rate,
            n_admitted=len(self.result.outcomes))


class OnlineProvisioner(BaseProvisioner):
    """Event-driven counterpart of ``Provisioner``: requests arrive at
    ``ServiceRequest.arrival``, each admitted arrival re-runs
    allocate -> plan over the residual scenario with in-flight batches
    pinned.  ``scheduler`` / ``allocator`` / ``admission`` take names or
    callables; ``allocator_kwargs`` / ``admission_kwargs`` pass through
    to them.  ``workload`` is a ``WORKLOADS`` name (built on ``device``)
    or an instance.  ``engine``/``device``/``seed``/``execute``
    are the shared facade kwargs (``api/base.py``);
    ``execute=True`` replays the committed batch sequence on the
    workload's executor after the simulation (``replay_result``)."""

    def __init__(self, scenario: Scenario, *, scheduler="stacking",
                 allocator="pso", admission="admit_all",
                 delay: Optional[DelayModel] = None,
                 quality: Optional[QualityModel] = None,
                 allocator_kwargs: Optional[dict] = None,
                 admission_kwargs: Optional[dict] = None,
                 engine: Optional[str] = None, workload=None,
                 device="cuda", seed: Optional[int] = None,
                 execute=None, execute_kwargs: Optional[dict] = None):
        super().__init__(scenario, engine=engine, device=device,
                         seed=seed, execute=execute,
                         execute_kwargs=execute_kwargs)
        self.scheduler_name = display_name(scheduler)
        self.allocator_name = display_name(allocator)
        self.admission_name = display_name(admission)
        self.scheduler = resolve(SCHEDULERS, scheduler, "scheduler")
        self.allocator = resolve(ALLOCATORS, allocator, "allocator")
        self.admission = resolve(ADMISSIONS, admission, "admission")
        wl = make_workload(workload, device)
        self.workload = wl
        self.delay = delay if delay is not None else (
            wl.default_delay() if wl else DelayModel())
        self.quality = quality if quality is not None else (
            wl.default_quality() if wl else PowerLawFID())
        self.allocator_kwargs = self._seeded_kwargs(self.allocator,
                                                    allocator_kwargs)
        self.admission_kwargs = dict(admission_kwargs or {})

    def run(self, generator: Optional[torch.Generator] = None, *,
            validate: bool = True, execute=None,
            latents: Optional[Mapping[int, Any]] = None) -> OnlineReport:
        """Simulate the arrival sequence; with ``execute=True`` (or a
        constructor default), replay the committed batches on the
        workload's executor and attach content + measured timings.
        ``generator`` (default: from ``seed=``) and ``latents`` (initial
        noise per service id) reach the replay's session."""
        mode = self._resolve_execute(execute)
        if mode in ("open", "closed"):
            raise ValueError(
                "online execution replays the simulated batch sequence; "
                "use execute=True (closed-loop modes apply to the static "
                "Provisioner)")
        allocator = with_kwargs(self.allocator, self.allocator_kwargs)
        admission = with_kwargs(self.admission, self.admission_kwargs)
        with self._planning():
            result = simulate_online(
                self.scenario, self.scheduler, allocator,
                delay=self.delay, quality=self.quality,
                admission=admission, validate=validate)
        report = OnlineReport(
            scenario=self.scenario, result=result, delay=self.delay,
            quality=self.quality, scheduler_name=self.scheduler_name,
            allocator_name=self.allocator_name,
            admission_name=self.admission_name)
        if mode is True:
            if self.workload is None and \
                    "executor" not in self.execute_kwargs:
                raise ValueError(
                    "execute=True needs a workload= to replay on "
                    "(or an executor= in execute_kwargs)")
            kw = dict(self.execute_kwargs)
            if latents is not None:
                kw["executor_kwargs"] = dict(kw.get("executor_kwargs") or {},
                                             latents=latents)
            out = replay_result(self.workload, result, self.delay,
                                self._resolve_generator(generator), **kw)
            report.content = out.content
            report.timings = list(out.timings or [])
        return report
