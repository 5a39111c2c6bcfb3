"""The one-call end-to-end pipeline, on the port.

    from repro_torch.api import Provisioner
    report = Provisioner(scenario, workload="diffusion",
                         scheduler="stacking", allocator="inv_se").run()

runs P1 (bandwidth allocation) -> P2 (batch-denoising plan) -> validate
-> simulate -> execution on the workload's model (the U-Net, or the
transformer for ``workload="llm_decode"``), and bundles the result
in a ``ProvisionReport``.  Omitting the workload gives the analytic
pipeline alone.  ``execute="open"``/``"closed"`` drives the plan through
``core/execution.py``'s ``ExecutionLoop`` (measure -> refit ->
replan).  The port of ``repro.api.provisioner.Provisioner``'s static
path; components are chosen by name from the registries
(``api/registry.py``: ``SCHEDULERS``, ``ALLOCATORS``, ``WORKLOADS``),
or passed as callables.  ``engine=`` picks the planner engine
(``repro_torch.core.arrays``) for the whole run; ``"torch"`` plans on
the Provisioner's ``device``.  The shared facade kwargs (``seed=``,
``execute=``) come from ``api/base.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.base import BaseProvisioner
from repro_torch.api.execution import execute_plan, with_kwargs
from repro_torch.api.protocols import WorkloadOutput
from repro_torch.api.registry import (ALLOCATORS, SCHEDULERS, WORKLOADS,
                                      display_name)
from repro_torch.core.bandwidth import make_plan
from repro_torch.core.delay_model import DelayModel, fit
from repro_torch.core.execution import ExecutionResult
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.core.service import Scenario
from repro_torch.core.simulator import SimResult, simulate
from repro_torch.core.torchplan import device_scope


def make_workload(workload, device):
    """A workload instance: a ``WORKLOADS`` name built on ``device``, or
    the given instance (``None`` for the analytic pipeline)."""
    if isinstance(workload, str):
        return WORKLOADS.get(workload)(device=device)
    return workload


@dataclasses.dataclass
class ProvisionReport:
    """Everything one provisioning round produced."""
    scenario: Scenario
    allocation: np.ndarray                    # B_k (Hz), sums to budget
    tau_prime: Dict[int, float]               # generation budgets
    plan: BatchPlan                           # P2 solution
    sim: SimResult                            # analytic timeline + quality
    content: Optional[Dict[int, Any]] = None  # images or tokens
    timings: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)                 # measured (batch_size, s)
    delay: Optional[DelayModel] = None
    quality: Optional[QualityModel] = None
    scheduler_name: str = ""
    allocator_name: str = ""
    workload_name: str = ""
    execution: Optional[ExecutionResult] = None  # closed/open-loop run

    @property
    def mean_fid(self) -> float:
        return self.sim.mean_fid

    @property
    def outage_rate(self) -> float:
        return self.sim.outage_rate

    def refit_delay(self) -> DelayModel:
        """Fit g(X) = aX + b from this run's measured per-batch timings
        (requires a timed execution with >= 2 distinct batch sizes): the
        calibrate->replan loop's measurement half."""
        sizes = [x for x, _ in self.timings]
        if len(set(sizes)) < 2:
            raise ValueError(
                "need timed batches of >= 2 distinct sizes to refit; "
                "run with timed=True on a plan with varied batch sizes")
        m = fit(sizes, [s for _, s in self.timings])
        # least squares can extrapolate a (slightly) negative slope or
        # intercept from noisy timings; delays are physically nonnegative
        # and the schedulers require g(X) > 0
        return DelayModel(a=max(m.a, 0.0), b=max(m.b, 1e-6))

    def summary(self) -> str:
        head = (f"[{self.workload_name or 'analytic'}] "
                f"scheduler={self.scheduler_name} "
                f"allocator={self.allocator_name} "
                f"batches={self.plan.num_batches}")
        body = head + "\n" + self.sim.summary()
        if self.execution is not None:
            body += "\n" + self.execution.summary()
        return body

    def to_dict(self) -> dict:
        """JSON-serializable aggregates, no model artifacts: the keys of
        the reference's ``report_dict`` protocol, plus the execution's
        own ``to_dict`` and its per-bucket telemetry."""
        mean_fid = self.mean_fid
        d = {
            "kind": "provision",
            "mean_fid": None if np.isnan(mean_fid) else float(mean_fid),
            "outage_rate": float(self.outage_rate),
            "makespan": float(self.plan.makespan()),
            "components": {"scheduler": self.scheduler_name,
                           "allocator": self.allocator_name,
                           "workload": self.workload_name},
            "telemetry": {"batches": self.plan.num_batches,
                          "timings": [[int(x), float(s)]
                                      for x, s in self.timings]},
            "n_services": self.scenario.K,
        }
        if self.execution is not None:
            d["execution"] = self.execution.to_dict()
            d["telemetry"]["exec_engine"] = d["execution"]["exec_engine"]
            d["telemetry"]["per_bucket"] = \
                d["execution"]["telemetry"]["per_bucket"]
        return d


class Provisioner(BaseProvisioner):
    """Binds a scenario to one (workload, scheduler, allocator) choice.

    workload: ``None`` (analytic only), ``"diffusion"`` (a
    ``DiffusionWorkload`` on ``device``), ``"llm_decode"`` (a
    ``DecodeWorkload`` on ``device``) or a workload instance.
    ``allocator_kwargs`` pass through to the P1 solver
    (``num_particles``, ``iters``, ``seed``, ...).  ``execute`` is
    ``run()``'s default execution mode (see ``run``); ``execute_kwargs``
    tunes the loop (``window``, ``drift_tol``, ``min_batches``,
    ``max_replans``, ``headroom``, ``executor``, ``executor_kwargs``,
    plus ``exec_engine="bucketed"`` for the diffusion sessions'
    pool engine).  ``engine`` pins the planner engine (``"vec"``,
    ``"scalar"``, ``"torch"``; ``None`` = the process default) around
    allocation, planning and every closed-loop replan; the ``"torch"``
    engine runs on ``device``.  ``seed`` reaches a seeded allocator
    (``pso``) and is the default generator of ``run``.  The components
    may still come positionally after the scenario, in ``_LEGACY``'s
    order: deprecated (``BaseProvisioner``'s shim)."""

    _LEGACY = ("workload", "scheduler", "allocator", "delay", "quality",
               "allocator_kwargs", "engine")
    _LEGACY_DEFAULTS = {"workload": None, "scheduler": "stacking",
                        "allocator": "pso", "delay": None,
                        "quality": None, "allocator_kwargs": None,
                        "engine": None}

    def __init__(self, scenario: Scenario, *args, workload=None,
                 scheduler="stacking", allocator="pso",
                 delay: Optional[DelayModel] = None,
                 quality: Optional[QualityModel] = None,
                 allocator_kwargs: Optional[dict] = None,
                 device="cuda", execute=None,
                 execute_kwargs: Optional[dict] = None,
                 engine: Optional[str] = None,
                 seed: Optional[int] = None):
        kw = self._legacy_positionals(args, dict(
            workload=workload, scheduler=scheduler, allocator=allocator,
            delay=delay, quality=quality,
            allocator_kwargs=allocator_kwargs, engine=engine))
        workload, scheduler, allocator = (kw["workload"], kw["scheduler"],
                                          kw["allocator"])
        delay, quality = kw["delay"], kw["quality"]
        allocator_kwargs, engine = kw["allocator_kwargs"], kw["engine"]
        super().__init__(scenario, engine=engine, device=device,
                         seed=seed, execute=execute,
                         execute_kwargs=execute_kwargs)
        self.scheduler_name = display_name(scheduler)
        self.allocator_name = display_name(allocator)
        self.scheduler = SCHEDULERS.resolve(scheduler)
        self.allocator = ALLOCATORS.resolve(allocator)
        wl = make_workload(workload, device)
        self.workload = wl
        self.workload_name = getattr(wl, "name", "") if wl else ""
        self.delay = delay if delay is not None else (
            wl.default_delay() if wl else DelayModel())
        self.quality = quality if quality is not None else (
            wl.default_quality() if wl else PowerLawFID())
        self.allocator_kwargs = self._seeded_kwargs(self.allocator,
                                                    allocator_kwargs)

    # -- pipeline stages ------------------------------------------------
    def allocate(self) -> np.ndarray:
        """P1: bandwidth allocation under the current delay/quality."""
        with obs.span("allocate"), self._planning():
            return np.asarray(self.allocator(
                self.scenario, self.scheduler, self.delay, self.quality,
                **self.allocator_kwargs))

    def plan(self, alloc: np.ndarray) -> Tuple[Dict[int, float], BatchPlan]:
        """P2: generation budgets + batch plan under an allocation."""
        with obs.span("plan"), self._planning():
            return make_plan(self.scenario, alloc, self.scheduler,
                             self.delay, self.quality)

    def calibrate(self, generator: Optional[torch.Generator] = None,
                  **kw) -> DelayModel:
        """Measure the workload's real g(X) and adopt it for planning."""
        if self.workload is None:
            raise ValueError("no workload to calibrate against")
        self.delay = self.workload.calibrate(generator, **kw)
        return self.delay

    # -- one-call end-to-end --------------------------------------------
    def run(self, generator: Optional[torch.Generator] = None, *,
            execute=None, timed: bool = False, calibrate: bool = False,
            refit: bool = False, validate: bool = True,
            latents: Optional[Mapping[int, Any]] = None
            ) -> ProvisionReport:
        """(calibrate) -> allocate -> plan -> (validate) -> simulate ->
        execute.

        execute: ``None`` falls back to the constructor's ``execute=``
            (default: one-shot workload execution).  ``True`` runs
            ``workload.execute`` open loop; ``False`` executes nothing;
            ``"open"``/``"closed"`` drive the plan through
            ``ExecutionLoop`` (measured wall-clock, rolling delay refit;
            ``"closed"`` also replans mid-flight on drift) and attach
            the ``ExecutionResult`` as ``report.execution``.
        calibrate: measure the workload's delay curve first and plan
            with the fitted model (the Fig.-1a loop).
        timed: record per-batch wall clock during execution.
        refit: refit ``self.delay`` in place from the measured timings
            so the *next* ``run`` plans with them; implies
            ``timed=True`` and needs an executing workload.
        latents: initial noise per service id (default: drawn from
            ``generator``, itself seeded from ``seed=`` when not given),
            in the one-shot and the loop paths alike.
        """
        with obs.span("round", K=self.scenario.K):
            mode = self._resolve_execute(execute)
            generator = self._resolve_generator(generator)
            if mode is None:
                mode = True                    # default: one-shot execution
            if refit:
                if mode is False or self.workload is None:
                    raise ValueError(
                        "refit=True needs measured timings: attach a "
                        "workload and keep execute=True")
                timed = True                   # refit is meaningless untimed
            if calibrate:
                self.calibrate(generator)
            alloc = self.allocate()
            tp, plan = self.plan(alloc)
            if validate:
                with obs.span("validate"):
                    plan.validate(gen_deadlines=tp)
            with obs.span("simulate"):
                sim = simulate(self.scenario, alloc, plan, self.quality)
            out = WorkloadOutput(content=None)
            execution = None
            if mode is True and self.workload is not None:
                out = self.workload.execute(plan, generator, timed=timed,
                                            latents=latents)
            elif mode in ("open", "closed"):
                kw = dict(self.execute_kwargs)
                if latents is not None:
                    kw["executor_kwargs"] = dict(
                        kw.get("executor_kwargs") or {}, latents=latents)
                with device_scope(self.device):
                    execution = execute_plan(
                        self.scenario, plan, alloc, self.workload,
                        mode=mode, generator=generator,
                        scheduler=self.scheduler,
                        allocator=with_kwargs(self.allocator,
                                              self.allocator_kwargs),
                        delay=self.delay, quality=self.quality,
                        engine=self.engine, validate=validate, **kw)
                out = WorkloadOutput(content=execution.content,
                                     timings=execution.timings)
            report = ProvisionReport(
                scenario=self.scenario, allocation=alloc, tau_prime=tp,
                plan=plan, sim=sim, content=out.content,
                timings=out.timings, delay=self.delay, quality=self.quality,
                scheduler_name=self.scheduler_name,
                allocator_name=self.allocator_name,
                workload_name=self.workload_name, execution=execution)
            if refit:
                self.delay = report.refit_delay()
            return report
