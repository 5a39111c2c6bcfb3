"""Multi-server provisioning: placement x per-cell bandwidth allocation.

The paper provisions ONE edge server: P1 splits one cell's bandwidth,
P2 plans one server's batches.  This module scales the same pipeline
out to M edge cells (``Scenario.servers``, each an ``EdgeServer`` with
its own bandwidth budget, compute speed and capacity):

  placement      assignment[k] = m — which cell hosts service k
                 (strategies live in ``repro_torch.api.placements``,
                 named in its PLACEMENTS dict)
  per-cell P1    each cell's allocator splits *its own* budget across
                 the services placed there
  per-cell P2    each cell's scheduler plans its own batches under the
                 cell's delay model (speed-scaled)

``provision_multi`` is the static composition; ``simulate_online_multi``
replays it event-driven with one ``_ServerTrack`` per server atop the
``core/online.py`` loop (arrivals route to a server at admission time
and stay there).  With one server both reproduce the single-server
``simulate`` / ``simulate_online`` results exactly.

A NumPy copy of ``repro.core.multiserver``:
tests/test_torch_multiserver.py holds its assignments, plans and
outcomes ``==`` to the original's on the vec and scalar engines.
``engine="torch"`` plans every cell on ``torchplan.device_scope``'s
device.  A bad assignment raises ``ValueError`` where the original
asserts.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import arrays
from repro_torch.core.bandwidth import evaluate, make_plan
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.online import (AdmissionDecision, AdmissionFn,
                                     AllocatorFn, OnlineResult,
                                     _collect_result, _project,
                                     _ServerTrack, _ServiceState)
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.core.service import EdgeServer, Scenario, ServiceRequest
from repro_torch.core.simulator import ServiceOutcome, SimResult, simulate

# (svc, simulation) -> server index; the per-arrival routing hook of the
# online loop.  Static placements (full-assignment vectors) live in
# repro_torch.api.placements.
OnlinePlacementFn = Callable[..., int]


def split_scenario(scn: Scenario,
                   assignment: Sequence[int]) -> List[Scenario]:
    """One single-cell sub-scenario per server: the services placed on
    it (scenario order preserved) under the cell's own bandwidth budget.

    ``assignment[i]`` is the server index of ``scn.services[i]``.
    Capacity caps are enforced here so every consumer of an assignment
    (static pipeline, placements, tests) shares one check.
    """
    servers = scn.server_list
    assignment = list(assignment)
    if len(assignment) != scn.K:
        raise ValueError(f"assignment covers {len(assignment)} of {scn.K} "
                         f"services")
    subs = []
    for m, server in enumerate(servers):
        members = [s for s, a in zip(scn.services, assignment) if a == m]
        if server.capacity is not None and len(members) > server.capacity:
            raise ValueError(f"server {m} hosts {len(members)} > capacity "
                             f"{server.capacity}")
        subs.append(Scenario(services=members,
                             total_bandwidth_hz=server.bandwidth_hz,
                             content_bits=scn.content_bits))
    bad = [a for a in assignment if not 0 <= a < len(servers)]
    if bad:
        raise ValueError(f"assignment references unknown servers {bad}")
    return subs


def cell_objective(sub_scn: Scenario, scheduler, allocator,
                   delay: DelayModel, quality: QualityModel) -> float:
    """Summed FID of one cell under its own allocate -> plan pipeline
    (summed, not mean, so per-cell objectives add up to the system
    objective — what the placement searches compare)."""
    if not sub_scn.services:
        return 0.0
    alloc = np.asarray(allocator(sub_scn, scheduler, delay, quality))
    return evaluate(sub_scn, alloc, scheduler, delay, quality) * sub_scn.K


@dataclasses.dataclass
class ServerPlanReport:
    """One cell's share of a static multi-server round."""
    server: EdgeServer
    scenario: Scenario                 # the cell's sub-scenario
    allocation: np.ndarray             # B_k within the cell's budget
    tau_prime: Dict[int, float]
    plan: BatchPlan
    sim: SimResult


@dataclasses.dataclass
class MultiSimResult:
    """Per-server plans + the merged per-service view (scenario order)."""
    assignment: List[int]              # server index per service
    per_server: List[ServerPlanReport]   # non-empty cells only
    outcomes: List[ServiceOutcome]     # all services, scenario order
    mean_fid: float
    outage_rate: float


def _merge_outcomes(scn: Scenario,
                    per_server: List[ServerPlanReport]
                    ) -> List[ServiceOutcome]:
    by_id = {o.id: o for rep in per_server for o in rep.sim.outcomes}
    return [by_id[s.id] for s in scn.services]


def provision_multi(scn: Scenario, assignment: Sequence[int], scheduler,
                    allocator, delay: Optional[DelayModel] = None,
                    quality: Optional[QualityModel] = None,
                    validate: bool = True,
                    engine: Optional[str] = None) -> MultiSimResult:
    """Static multi-server pipeline: per-cell allocate -> plan ->
    simulate under a given placement.

    ``delay`` is the baseline hardware model; each cell plans with its
    speed-scaled version (``EdgeServer.delay_model``).  With one server
    and the identity assignment this is exactly the single-server
    ``run_scheme`` composition.  ``engine`` pins the planning engine
    for every cell's plan (``repro_torch.core.arrays``; ``None`` = process
    default).
    """
    delay = delay if delay is not None else DelayModel()
    quality = quality if quality is not None else PowerLawFID()
    subs = split_scenario(scn, assignment)
    per_server = []
    with arrays.engine_scope(engine):
        for server, sub in zip(scn.server_list, subs):
            if not sub.services:
                continue
            cell_delay = server.delay_model(delay)
            alloc = np.asarray(allocator(sub, scheduler, cell_delay,
                                         quality))
            tp, plan = make_plan(sub, alloc, scheduler, cell_delay,
                                 quality)
            if validate:
                plan.validate(gen_deadlines=tp)
            per_server.append(ServerPlanReport(
                server=server, scenario=sub, allocation=alloc,
                tau_prime=tp, plan=plan,
                sim=simulate(sub, alloc, plan, quality)))
    outcomes = _merge_outcomes(scn, per_server)
    mean_fid = float(np.mean([o.fid for o in outcomes]))
    outage = float(np.mean([0.0 if o.met_deadline else 1.0
                            for o in outcomes]))
    return MultiSimResult(assignment=list(assignment),
                          per_server=per_server, outcomes=outcomes,
                          mean_fid=mean_fid, outage_rate=outage)


# -- online: one _ServerTrack per cell ------------------------------------

@dataclasses.dataclass
class MultiOnlineResult:
    """OnlineResult plus where every admitted service ran."""
    result: OnlineResult
    assignment: Dict[int, int]         # admitted service id -> server id
    handoffs: int = 0                  # cross-cell migrations performed
    handoff_log: List[tuple] = dataclasses.field(default_factory=list)
    # handoff_log entries: (t, service_id, from_server, to_server)

    @property
    def outcomes(self):
        return self.result.outcomes

    @property
    def mean_fid(self) -> float:
        return self.result.mean_fid

    @property
    def outage_rate(self) -> float:
        return self.result.outage_rate

    @property
    def reject_rate(self) -> float:
        return self.result.reject_rate


def earliest_free(svc: ServiceRequest,
                  sim: "MultiOnlineSimulation") -> int:
    """Default online placement: the server that frees up first among
    those with capacity room (ties by fewest hosted services, then by
    server id, so simultaneous arrivals spread instead of piling onto
    cell 0).  With one server this is the identity routing of the
    single-server loop."""
    candidates = [m for m, tr in enumerate(sim.tracks)
                  if sim.servers[m].has_room(len(tr.owned))]
    if not candidates:   # cluster full: the arrival loop force-rejects
        candidates = list(range(len(sim.tracks)))
    return min(candidates,
               key=lambda m: (sim.tracks[m].t_free,
                              len(sim.tracks[m].owned), m))


def best_projection(svc: ServiceRequest,
                    sim: "MultiOnlineSimulation") -> int:
    """Marginal-gain online placement: trial-replan the newcomer on every
    cell with room and route to the best projected outcome (feasible
    first, then lowest projected FID, then earliest generation end).

    Probe plans are stashed in ``sim`` so the arrival loop reuses the
    chosen cell's trial instead of re-solving it."""
    candidates = [m for m, tr in enumerate(sim.tracks)
                  if sim.servers[m].has_room(len(tr.owned))]
    if not candidates:   # cluster full: the arrival loop force-rejects
        candidates = list(range(len(sim.tracks)))
    best_m, best_key = candidates[0], None
    for m in candidates:
        tr = sim.tracks[m]
        t_free = max(svc.arrival, tr.t_free)
        trial = tr.replan(tr.pending | {svc.id}, t_free)
        tr.replan_count -= 1          # probing, not a real replan
        sim.offer_trial(svc.id, m, trial)
        p = _project(svc, trial, sim.quality, sim.scn.content_bits)
        key = (0 if p.met_deadline else 1, p.fid, p.e2e_delay, m)
        if best_key is None or key < best_key:
            best_m, best_key = m, key
    return best_m


class MultiOnlineSimulation:
    """The ``repro_torch.core.online`` arrival loop over M server tracks.

    Each arrival is routed to one server by ``placement`` (an
    ``OnlinePlacementFn``), trial-replanned *on that server only*, and —
    if admitted — pinned there for life: batches execute on its cell's
    speed-scaled delay model and its content transmits over the cell's
    own bandwidth.  Other cells keep running untouched, which is what
    makes M cells an M-fold throughput axis.
    """

    def __init__(self, scn: Scenario, scheduler, allocator: AllocatorFn,
                 delay: DelayModel, quality: QualityModel,
                 admission: AdmissionFn,
                 placement: Optional[OnlinePlacementFn] = None,
                 handoff: bool = False, validate: bool = True):
        self.scn = scn
        self.quality = quality
        self.admission = admission
        self.placement = placement if placement is not None else \
            earliest_free
        self.handoff = handoff
        self.handoff_count = 0
        self.handoff_log: List[tuple] = []
        self.servers = scn.server_list
        self.states: Dict[int, _ServiceState] = {
            s.id: _ServiceState(s) for s in scn.services}
        self.tracks = [
            _ServerTrack(scn, sv.bandwidth_hz, scheduler, allocator,
                         sv.delay_model(delay), quality, self.states,
                         validate=validate)
            for sv in self.servers
        ]
        self.decisions: List[AdmissionDecision] = []
        self.assignment: Dict[int, int] = {}
        self._probed: Dict[tuple, object] = {}   # (svc_id, m) -> trial plan

    @property
    def replan_count(self) -> int:
        return sum(tr.replan_count for tr in self.tracks)

    def server_of(self, svc_id: int) -> Optional[int]:
        return self.assignment.get(svc_id)

    def offer_trial(self, svc_id: int, m: int, trial) -> None:
        """A placement that already trial-replanned ``svc`` on cell
        ``m`` (e.g. ``best_projection``) deposits the plan here; the
        arrival loop reuses it instead of re-solving.  Valid only
        within the current arrival (the loop clears the stash)."""
        self._probed[(svc_id, m)] = trial

    def _force_reject(self, svc: ServiceRequest) -> None:
        """Capacity is a hard constraint: an arrival routed to a full
        cell is rejected before any trial replan (the projected outcome
        is the zero-step outage row the admission policy would see)."""
        projected = ServiceOutcome(
            id=svc.id, deadline=svc.deadline, steps=0, gen_delay=0.0,
            tx_delay=0.0, e2e_delay=0.0, fid=self.quality.fid(0),
            met_deadline=False)
        self.states[svc.id].admitted = False
        self.decisions.append(AdmissionDecision(
            id=svc.id, arrival=svc.arrival, admitted=False,
            projected=projected))

    # -- cross-cell handoff ----------------------------------------------

    def _handoff_pass(self, t_now: float) -> None:
        """Migrate pending not-yet-started services to a better cell.

        Runs at each replan instant (after an arrival is processed).  A
        service that was admitted but has executed zero denoising steps
        is not bound to its cell by any progress, so it may move: every
        other cell with room trial-replans with the service included,
        and the service migrates to the best strictly better projected
        outcome (feasibility first, then FID, then generation end —
        the ``best_projection`` ordering).  Ties never move, so the
        pass cannot ping-pong; services with executed steps never move,
        so progress is never re-run (the no-resurrection invariant
        holds per track).  With one cell this is a no-op, preserving
        the single-server bit-exactness invariant.
        """
        candidates = sorted(
            k for tr in self.tracks for k in tr.pending
            if self.states[k].steps_done == 0)
        for k in candidates:
            src = self.assignment.get(k)
            if src is None:
                continue
            s_tr = self.tracks[src]
            svc = self.states[k].svc
            cur = _project(svc, s_tr.active, self.quality,
                           self.scn.content_bits)
            cur_key = (0 if cur.met_deadline else 1, cur.fid,
                       cur.e2e_delay)
            best = None
            for m, tr in enumerate(self.tracks):
                if m == src or not self.servers[m].has_room(
                        len(tr.owned)):
                    continue
                t_free = max(t_now, tr.t_free)
                trial = tr.replan(tr.pending | {k}, t_free)
                tr.replan_count -= 1          # probing, not a replan yet
                p = _project(svc, trial, self.quality,
                             self.scn.content_bits)
                key = (0 if p.met_deadline else 1, p.fid, p.e2e_delay, m)
                if key[:3] < cur_key and (best is None or key < best[0]):
                    best = (key, m, trial)
            if best is not None:
                self._migrate(k, src, best[1], best[2], t_now)

    def _migrate(self, k: int, src: int, dst: int, trial,
                 t_now: float) -> None:
        """Move service ``k`` (no executed steps) from cell ``src`` to
        ``dst``: the source replans without it, the destination adopts
        the trial plan that included it."""
        s_tr, d_tr = self.tracks[src], self.tracks[dst]
        s_tr.pending.discard(k)
        s_tr.owned.discard(k)
        remaining = set(s_tr.pending)
        if remaining:
            s_tr.active = s_tr.replan(remaining,
                                      max(t_now, s_tr.t_free))
            s_tr._settle_no_step_services(s_tr.active)
        else:
            s_tr.active = None
        d_tr.replan_count += 1                # the probe became real
        d_tr.adopt(k, trial)
        self.assignment[k] = dst
        self.handoff_count += 1
        self.handoff_log.append((t_now, k, src, dst))

    def run(self) -> MultiOnlineResult:
        for svc in sorted(self.scn.services,
                          key=lambda s: (s.arrival, s.id)):
            for tr in self.tracks:
                tr.execute_until(svc.arrival)
            m = int(self.placement(svc, self))
            tr = self.tracks[m]
            if not self.servers[m].has_room(len(tr.owned)):
                # enforced here, not just in the built-in routers, so a
                # custom placement can never oversubscribe a cell — the
                # online mirror of split_scenario's capacity check
                self._probed.clear()
                self._force_reject(svc)
                continue
            t_free = max(svc.arrival, tr.t_free)
            trial = self._probed.get((svc.id, m))
            if trial is not None:
                tr.replan_count += 1   # the probe becomes the real replan
            else:
                trial = tr.replan(tr.pending | {svc.id}, t_free)
            self._probed.clear()
            projected = _project(svc, trial, self.quality,
                                 self.scn.content_bits)
            admit = bool(self.admission(svc, projected, self.states))
            self.states[svc.id].admitted = admit
            self.decisions.append(AdmissionDecision(
                id=svc.id, arrival=svc.arrival, admitted=admit,
                projected=projected))
            if admit:
                tr.adopt(svc.id, trial)
                self.assignment[svc.id] = m
            # on reject every track's plan keeps running untouched
            if self.handoff and len(self.tracks) > 1:
                self._handoff_pass(svc.arrival)
        for tr in self.tracks:
            tr.execute_until(math.inf)
        result = _collect_result(self.scn, self.states, self.decisions,
                                 self.quality)
        return MultiOnlineResult(result=result,
                                 assignment=dict(self.assignment),
                                 handoffs=self.handoff_count,
                                 handoff_log=list(self.handoff_log))


def simulate_online_multi(scn: Scenario, scheduler,
                          allocator: AllocatorFn,
                          delay: Optional[DelayModel] = None,
                          quality: Optional[QualityModel] = None,
                          admission: Optional[AdmissionFn] = None,
                          placement: Optional[OnlinePlacementFn] = None,
                          handoff: bool = False,
                          validate: bool = True,
                          engine: Optional[str] = None
                          ) -> MultiOnlineResult:
    """Event-driven arrivals over M edge cells (module docstring).

    ``placement`` routes each arrival to a server (default
    ``earliest_free``; ``best_projection`` trial-replans everywhere).
    ``handoff=True`` additionally runs a cross-cell handoff pass at
    every replan instant: pending services with no executed steps may
    migrate to a cell whose trial replan projects a strictly better
    outcome (``MultiOnlineResult.handoffs`` counts the moves).  With
    ``scn.n_servers == 1`` any placement (and the handoff pass, which
    has no other cell to probe) degenerates to the single-server
    ``simulate_online`` path bit-for-bit.  ``engine`` pins the
    planning engine for every track's replans (``repro_torch.core.arrays``;
    ``None`` = process default).
    """
    if admission is None:
        admission = lambda svc, projected, states: True   # noqa: E731
    sim = MultiOnlineSimulation(
        scn, scheduler, allocator,
        delay if delay is not None else DelayModel(),
        quality if quality is not None else PowerLawFID(),
        admission, placement=placement, handoff=handoff,
        validate=validate)
    with arrays.engine_scope(engine):
        return sim.run()
