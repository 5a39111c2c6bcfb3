"""Multi-server front end: placement x per-cell provisioning.

    from repro_torch.api import MultiServerProvisioner
    from repro_torch.core.service import make_scenario

    scn = make_scenario(K=12, n_servers=3,
                        server_speed_range=(0.7, 1.3), seed=0)
    multi = MultiServerProvisioner(scn, placement="greedy_fid",
                                   scheduler="stacking",
                                   allocator="inv_se").run()
    print(multi.summary())

``MultiServerProvisioner`` is ``Provisioner`` scaled out to M edge
cells: a *placement* strategy (``PLACEMENTS``) decides which cell
hosts each service, then every cell runs the familiar per-cell
allocate -> plan -> simulate pipeline (on its own bandwidth budget and
speed-scaled delay model).  ``run`` returns a ``MultiProvisionReport``
bundling one ``ProvisionReport`` per non-empty server plus the merged
per-service view; ``run_online`` is the event-driven counterpart
(arrivals routed to a server at admission time, one plan track per
cell — see ``core/multiserver.py``).

With ``n_servers == 1`` both paths reproduce the single-server
``Provisioner`` / ``OnlineProvisioner`` results exactly.  The port of
``repro.api.multiserver``; ``engine="torch"`` plans the placement's
trial cells and every cell's plan on the facade's ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.api.base import BaseProvisioner, report_dict
from repro_torch.api.execution import with_kwargs
from repro_torch.api.provisioner import ProvisionReport
from repro_torch.api.registry import (ADMISSIONS, ALLOCATORS, PLACEMENTS,
                                      SCHEDULERS, display_name)
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.multiserver import (MultiOnlineResult, MultiSimResult,
                                          provision_multi,
                                          simulate_online_multi)
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.core.service import Scenario
from repro_torch.core.simulator import SimResult


@dataclasses.dataclass
class MultiProvisionReport:
    """Everything one multi-server round produced: the assignment, one
    ``ProvisionReport`` per non-empty cell, and the merged view."""
    scenario: Scenario
    assignment: np.ndarray                 # server index per service
    reports: List[ProvisionReport]         # one per non-empty server
    server_ids: List[int]                  # reports[i] ran on server_ids[i]
    sim: SimResult                         # merged, scenario order
    placement_name: str = ""
    scheduler_name: str = ""
    allocator_name: str = ""

    @property
    def mean_fid(self) -> float:
        return self.sim.mean_fid

    @property
    def outage_rate(self) -> float:
        return self.sim.outage_rate

    @property
    def n_servers(self) -> int:
        return self.scenario.n_servers

    def report_for(self, server_id: int) -> Optional[ProvisionReport]:
        for sid, rep in zip(self.server_ids, self.reports):
            if sid == server_id:
                return rep
        return None

    def summary(self) -> str:
        counts = {sid: rep.scenario.K
                  for sid, rep in zip(self.server_ids, self.reports)}
        head = (f"[multi x{self.n_servers}] "
                f"placement={self.placement_name} "
                f"scheduler={self.scheduler_name} "
                f"allocator={self.allocator_name} "
                f"services/server={counts}")
        return head + "\n" + self.sim.summary()

    def to_dict(self) -> dict:
        """Common report protocol (``api/base.py``'s ``report_dict``)."""
        makespans = [r.plan.makespan() for r in self.reports]
        return report_dict(
            "multi", mean_fid=self.mean_fid,
            outage_rate=self.outage_rate,
            makespan=max(makespans) if makespans else None,
            components={"placement": self.placement_name,
                        "scheduler": self.scheduler_name,
                        "allocator": self.allocator_name},
            telemetry={"services_per_server": {
                str(sid): rep.scenario.K
                for sid, rep in zip(self.server_ids, self.reports)}},
            n_servers=self.n_servers)


@dataclasses.dataclass
class MultiOnlineReport:
    """Online multi-server run: outcomes + admission log + where every
    admitted service ran."""
    scenario: Scenario
    result: MultiOnlineResult
    placement_name: str = ""
    scheduler_name: str = ""
    allocator_name: str = ""
    admission_name: str = ""

    @property
    def assignment(self) -> Dict[int, int]:
        return self.result.assignment

    @property
    def mean_fid(self) -> float:
        return self.result.mean_fid

    @property
    def outage_rate(self) -> float:
        return self.result.outage_rate

    @property
    def reject_rate(self) -> float:
        return self.result.reject_rate

    @property
    def handoffs(self) -> int:
        return self.result.handoffs

    def summary(self) -> str:
        head = (f"[multi-online x{self.scenario.n_servers}] "
                f"placement={self.placement_name} "
                f"scheduler={self.scheduler_name} "
                f"allocator={self.allocator_name} "
                f"admission={self.admission_name} "
                f"handoffs={self.handoffs}")
        return head + "\n" + self.result.result.summary()

    def to_dict(self) -> dict:
        """Common report protocol (``api/base.py``'s ``report_dict``)."""
        arrival = {s.id: s.arrival for s in self.scenario.services}
        times = [arrival[o.id] + o.e2e_delay
                 for o in self.result.result.outcomes if o.steps > 0]
        return report_dict(
            "multi_online", mean_fid=self.mean_fid,
            outage_rate=self.outage_rate,
            makespan=max(times) if times else None,
            components={"placement": self.placement_name,
                        "scheduler": self.scheduler_name,
                        "allocator": self.allocator_name,
                        "admission": self.admission_name},
            telemetry={"handoffs": self.handoffs},
            reject_rate=self.reject_rate,
            n_servers=self.scenario.n_servers)


class MultiServerProvisioner(BaseProvisioner):
    """Facade binding a (multi-server) scenario to one
    (placement, scheduler, allocator) choice.  All three accept names
    or callables; ``placement_kwargs`` / ``allocator_kwargs`` pass
    through to the underlying strategies.
    ``engine``/``device``/``seed``/``execute`` are the
    shared facade kwargs (``api/base.py``); the engine and its device
    cover the placement stage too.

    The static ``run`` is analytic (allocation + plans + simulated
    timelines); to execute on a real model, feed each ``reports[i]`` to
    ``repro_torch.api.execution.execute_report`` (``execute=`` here
    raises ``NotImplementedError`` pointing at that per-cell path).

    The ``placement`` strategy is a *static* full-assignment solver and
    applies to ``run`` only; ``run_online`` routes arrivals one at a
    time with its own ``online_placement`` hook (default
    earliest-free), since a static placement cannot see arrivals it
    does not know about yet.

    The components may still come positionally after the scenario, in
    ``_LEGACY``'s order: deprecated (``BaseProvisioner``'s shim).
    """

    _LEGACY = ("placement", "scheduler", "allocator", "delay", "quality",
               "placement_kwargs", "allocator_kwargs", "engine")
    _LEGACY_DEFAULTS = {"placement": "least_loaded",
                        "scheduler": "stacking", "allocator": "pso",
                        "delay": None, "quality": None,
                        "placement_kwargs": None,
                        "allocator_kwargs": None, "engine": None}

    def __init__(self, scenario: Scenario, *args,
                 placement="least_loaded", scheduler="stacking",
                 allocator="pso", delay: Optional[DelayModel] = None,
                 quality: Optional[QualityModel] = None,
                 placement_kwargs: Optional[dict] = None,
                 allocator_kwargs: Optional[dict] = None,
                 engine: Optional[str] = None, device="cuda",
                 seed: Optional[int] = None, execute=None):
        kw = self._legacy_positionals(args, dict(
            placement=placement, scheduler=scheduler, allocator=allocator,
            delay=delay, quality=quality,
            placement_kwargs=placement_kwargs,
            allocator_kwargs=allocator_kwargs, engine=engine))
        placement, scheduler = kw["placement"], kw["scheduler"]
        allocator, delay, quality = (kw["allocator"], kw["delay"],
                                     kw["quality"])
        placement_kwargs, allocator_kwargs = (kw["placement_kwargs"],
                                              kw["allocator_kwargs"])
        super().__init__(scenario, engine=kw["engine"], device=device,
                         seed=seed, execute=execute)
        self.placement_name = display_name(placement)
        self.scheduler_name = display_name(scheduler)
        self.allocator_name = display_name(allocator)
        self.placement = PLACEMENTS.resolve(placement)
        self.scheduler = SCHEDULERS.resolve(scheduler)
        self.allocator = ALLOCATORS.resolve(allocator)
        self.delay = delay if delay is not None else DelayModel()
        self.quality = quality if quality is not None else PowerLawFID()
        self.placement_kwargs = dict(placement_kwargs or {})
        self.allocator_kwargs = self._seeded_kwargs(self.allocator,
                                                    allocator_kwargs)

    def _check_no_execute(self, execute):
        mode = self._resolve_execute(execute)
        if mode:
            raise NotImplementedError(
                "multi-server execution is per cell: run() then feed "
                "each reports[i] to repro_torch.api.execution."
                "execute_report (or a per-cell Provisioner with "
                "execute=)")

    def _allocator(self):
        return with_kwargs(self.allocator, self.allocator_kwargs)

    def place(self) -> np.ndarray:
        """The placement stage alone: server index per service."""
        with self._planning():
            return np.asarray(self.placement(
                self.scenario, self.scheduler, self._allocator(),
                self.delay, self.quality, **self.placement_kwargs))

    def run(self, *, assignment=None, validate: bool = True,
            execute=None) -> MultiProvisionReport:
        """Place -> per-cell allocate -> plan -> validate -> simulate.

        ``assignment`` overrides the placement stage (a precomputed
        server index per service), mirroring ``Provisioner.run``'s
        compositionality.
        """
        self._check_no_execute(execute)
        if assignment is None:
            assignment = self.place()
        assignment = np.asarray(assignment)
        with self._planning():
            multi: MultiSimResult = provision_multi(
                self.scenario, assignment, self.scheduler,
                self._allocator(), self.delay, self.quality,
                validate=validate)
        reports, server_ids = [], []
        for rep in multi.per_server:
            reports.append(ProvisionReport(
                scenario=rep.scenario, allocation=rep.allocation,
                tau_prime=rep.tau_prime, plan=rep.plan, sim=rep.sim,
                delay=rep.server.delay_model(self.delay),
                quality=self.quality,
                scheduler_name=self.scheduler_name,
                allocator_name=self.allocator_name,
                workload_name=f"server{rep.server.id}"))
            server_ids.append(rep.server.id)
        merged = SimResult(outcomes=multi.outcomes,
                           mean_fid=multi.mean_fid,
                           outage_rate=multi.outage_rate)
        return MultiProvisionReport(
            scenario=self.scenario, assignment=assignment,
            reports=reports, server_ids=server_ids, sim=merged,
            placement_name=self.placement_name,
            scheduler_name=self.scheduler_name,
            allocator_name=self.allocator_name)

    def run_online(self, admission="admit_all", online_placement=None,
                   admission_kwargs: Optional[dict] = None, *,
                   handoff: bool = False, validate: bool = True,
                   execute=None) -> MultiOnlineReport:
        """Event-driven arrivals over the M cells.

        ``online_placement`` is a per-arrival router
        ``(svc, sim) -> server index`` (default: earliest-free cell;
        ``repro_torch.core.multiserver.best_projection`` trial-replans on
        every cell).  The constructor's static ``placement`` does NOT
        apply here — it solves a full assignment, which has no meaning
        when requests are revealed one at a time.  ``admission`` takes
        registered names or callables as in ``OnlineProvisioner``.
        ``handoff=True`` lets pending not-yet-started services migrate
        to a strictly better cell at each replan instant (the report's
        ``handoffs`` counts the moves).
        """
        self._check_no_execute(execute)
        adm = with_kwargs(ADMISSIONS.resolve(admission), admission_kwargs)
        with self._planning():
            result = simulate_online_multi(
                self.scenario, self.scheduler, self._allocator(),
                delay=self.delay, quality=self.quality, admission=adm,
                placement=online_placement, handoff=handoff,
                validate=validate)
        return MultiOnlineReport(
            scenario=self.scenario, result=result,
            placement_name=(display_name(online_placement)
                            if online_placement else "earliest_free"),
            scheduler_name=self.scheduler_name,
            allocator_name=self.allocator_name,
            admission_name=display_name(admission))
