"""Population-scale fleet simulation: thousands of cells, streaming
metrics, batched replans.

``core/multiserver.py`` holds a ``_ServiceState`` object per service
and one ``_ServerTrack`` per cell — exact, but the object graph tops
out at benchmark scale.  This module runs the same provisioning
pipeline (per-cell P1 allocate -> P2 STACKING plan -> admission) over a
*fleet*: per-cell arrival processes (``core/traffic.py``) generate
the load, per-cell event state lives in plain arrays/dicts of scalars
with **no per-service object retained after completion** (a completed
service leaves behind one streamed metric sample and, until its
content clears the air, a ``(tx_end, bandwidth)`` reservation), and
metrics aggregate online (running mean FID, outage rate, delay
percentiles from a fixed-size reservoir), so memory is bounded by the
number of *concurrently live* services, not the horizon.

Two execution modes:

``mode="event"``
    The exact online semantics of ``simulate_online_multi`` with
    placement pinned to each arrival's home cell: every arrival
    triggers a residual replan of its cell (shrunken deadlines,
    progress offsets, the ``doomed -> fid(0)`` objective, reserved
    transmission bandwidth).  Cells are independent, so the loop runs
    in lockstep *rounds* — round r replans every cell seeing its r-th
    arrival — and when the planning engine exposes a batched entry
    point (``engine="torch"``: ``torchplan.replan_many``), all of a
    round's replans go to the device as ONE call per distinct cell
    speed.  On an overlapping configuration this mode reproduces
    ``simulate_online_multi`` within the 1e-9 mean-FID contract of
    the planner engines.

``mode="epoch"``
    Batch-window provisioning for population scale: arrivals queue per
    epoch of width ``epoch`` and each cell plans its queue ONCE at
    ``t_plan = max(cell busy-until, latest queued arrival)``, so plans
    run to completion, no service is ever replanned (offsets never
    arise) and the entire epoch's planning across all cells is one
    batched ``replan_many`` call.  A service's outcome is final the
    moment its cell is planned, which is what makes >= 10^6 services
    tractable (benchmarks/fleet.py).  A configuration whose arrivals
    are spaced so that every plan drains before the next arrival (one
    arrival per epoch per cell) is *exactly* the event-mode run —
    the cross-mode test uses ``TraceArrivals`` (chunk-independent) to
    enforce it.

Only closed-form allocators (``"equal"``, ``"inv_se"``) are supported:
search allocators (pso, coordinate) run the scheduler inside their
fitness loop, which defeats batching; they remain available through
the per-scenario ``core/multiserver.py`` path.

A copy of ``repro.core.fleet`` with one change: the batched replans go
to the engine's own ``replan_many`` (``repro_torch.core.torchplan``,
float64 on ``torchplan.device_scope``'s device) where the original
imports ``jaxplan``.  tests/test_torch_fleet.py holds every
``FleetResult`` ``==`` to the original's on the vec and scalar
engines, and the torch engine within 1e-9 mean FID of vec with equal
counts; tests/test_torch_fleet_jax.py holds it to the original's jax
engine.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core import arrays
from repro_torch.core import stacking as stacking_mod
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.online import _OffsetQuality
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.core.service import EdgeServer, Scenario, ServiceRequest
from repro_torch.core.simulator import ServiceOutcome
from repro_torch.core.traffic import ArrivalProcess

_TIE = 1e-6           # deadline slack, matches core/online.py
_B_FLOOR = 1e-6       # uncommitted-bandwidth floor, matches online

#: fleet admission policy: (cell index, projected ServiceOutcome) -> admit?
FleetAdmissionFn = Callable[[int, ServiceOutcome], bool]


# -------------------------------------------------------------------------
# Streaming metrics
# -------------------------------------------------------------------------

class ReservoirQuantiles:
    """Fixed-size uniform reservoir (Vitter's Algorithm R) over a
    stream of floats; percentiles come from the sample.  O(capacity)
    memory regardless of stream length, deterministic under the seed."""

    def __init__(self, capacity: int = 4096, seed: int = 0):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._rng = np.random.default_rng([seed, 0xE5])
        self._buf = np.empty(capacity, dtype=np.float64)
        self.count = 0

    def add(self, x: float) -> None:
        n = self.count
        if n < self.capacity:
            self._buf[n] = x
        else:
            j = int(self._rng.integers(0, n + 1))
            if j < self.capacity:
                self._buf[j] = x
        self.count = n + 1

    def percentile(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        return float(np.percentile(
            self._buf[:min(self.count, self.capacity)], q))


class FleetMetrics:
    """Online aggregation of per-service outcomes: one ``observe`` per
    completed service, O(1) state plus the delay reservoir."""

    def __init__(self, seed: int = 0, reservoir: int = 4096):
        self.arrivals = 0
        self.admitted = 0
        self.rejected = 0
        self.completed = 0
        self.outages = 0
        self.mean_fid = 0.0          # running mean over completed
        self.delays = ReservoirQuantiles(capacity=reservoir, seed=seed)

    def observe(self, fid: float, met: bool, e2e: float) -> None:
        self.completed += 1
        self.mean_fid += (fid - self.mean_fid) / self.completed
        if not met:
            self.outages += 1
        if e2e > 0.0:
            self.delays.add(e2e)

    @property
    def outage_rate(self) -> float:
        return self.outages / self.completed if self.completed else 0.0

    @property
    def reject_rate(self) -> float:
        return self.rejected / self.arrivals if self.arrivals else 0.0


# -------------------------------------------------------------------------
# Fleet configuration
# -------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetCell:
    """One edge cell of the fleet: an ``EdgeServer`` worth of hardware
    plus the arrival process generating its local load (``None`` when
    the cell is fed only by the fleet's shared stream)."""
    bandwidth_hz: float
    speed: float = 1.0
    capacity: Optional[int] = None
    process: Optional[ArrivalProcess] = None

    def server(self, idx: int) -> EdgeServer:
        return EdgeServer(id=idx, bandwidth_hz=self.bandwidth_hz,
                          speed=self.speed, capacity=self.capacity)


@dataclasses.dataclass(frozen=True)
class FleetScenario:
    """A fleet: cells + load + the per-service attribute distributions.

    Service attributes are drawn from each cell's own substream
    (``np.random.default_rng([seed, cell])`` — arrivals first, then
    one uniform deadline and one uniform spectral efficiency per
    arrival), so a fleet run is reproducible from ``seed`` alone and
    cells are statistically independent.  ``shared_process`` adds a
    fleet-wide stream routed to cells by a placement policy
    (``simulate_fleet(placement=...)``); it draws from the substream
    ``[seed, n_cells]``.
    """
    cells: Tuple[FleetCell, ...]
    horizon: float
    seed: int = 0
    deadline_range: Tuple[float, float] = (1.0, 3.0)
    spectral_eff_range: Tuple[float, float] = (1.0, 4.0)
    content_bits: float = 2.0e6
    shared_process: Optional[ArrivalProcess] = None

    def __post_init__(self):
        object.__setattr__(self, "cells", tuple(self.cells))
        if not self.cells:
            raise ValueError("a fleet needs at least one cell")
        if not (self.horizon > 0 and math.isfinite(self.horizon)):
            raise ValueError(f"horizon must be finite and > 0, got "
                             f"{self.horizon}")
        for name in ("deadline_range", "spectral_eff_range"):
            lo, hi = getattr(self, name)
            if not (0 < lo <= hi):
                raise ValueError(f"{name} must satisfy 0 < lo <= hi, "
                                 f"got ({lo}, {hi})")

    @property
    def n_cells(self) -> int:
        return len(self.cells)


@dataclasses.dataclass(frozen=True)
class FleetResult:
    """Aggregate outcome of one fleet run — streaming statistics only,
    never per-service records."""
    mode: str
    engine: str
    arrivals: int
    admitted: int
    rejected: int
    completed: int
    mean_fid: float
    outage_rate: float
    reject_rate: float
    delay_p50: float
    delay_p95: float
    delay_p99: float
    peak_live_rows: int        # max concurrently-held service rows
    replans: int               # planner invocations (rows, not calls)
    planner_calls: int         # batched planner calls actually issued


# -------------------------------------------------------------------------
# Arrival sampling
# -------------------------------------------------------------------------

def _cell_rngs(fleet: FleetScenario, cell: int):
    """One cell's two substreams: arrival times and per-service
    attributes.  Attributes live on their own stream, drawn as one
    ``(n, 2)`` uniform block per window — ``Generator.random``
    consumes the stream sequentially, so any chunking of the horizon
    yields the same attribute sequence for the same arrival sequence
    (exact for ``TraceArrivals``, which the cross-mode equivalence
    test relies on)."""
    return (np.random.default_rng([fleet.seed, cell]),
            np.random.default_rng([fleet.seed, cell, 1]))


def _sample_cell(fleet: FleetScenario, proc: Optional[ArrivalProcess],
                 arr_rng: np.random.Generator,
                 attr_rng: np.random.Generator, t0: float, t1: float):
    """Arrivals + per-service attributes on ``[t0, t1)``:
    ``(times, deadlines, spectral_effs)``."""
    if proc is None:
        z = np.empty(0)
        return z, z.copy(), z.copy()
    times = proc.sample(arr_rng, t0, t1)
    u = attr_rng.random((times.size, 2))
    dlo, dhi = fleet.deadline_range
    elo, ehi = fleet.spectral_eff_range
    deadlines = dlo + (dhi - dlo) * u[:, 0]
    se = elo + (ehi - elo) * u[:, 1]
    return times, deadlines, se


# -------------------------------------------------------------------------
# Allocators (closed-form only — must match core/bandwidth.py op for
# op so the event mode stays inside the equivalence contract)
# -------------------------------------------------------------------------

def _alloc_equal(B: float, se: np.ndarray) -> np.ndarray:
    return np.full(se.size, B / se.size)


def _alloc_inv_se(B: float, se: np.ndarray) -> np.ndarray:
    inv = 1.0 / se
    return B * inv / inv.sum()


_ALLOCATORS = {"equal": _alloc_equal, "inv_se": _alloc_inv_se}


def _resolve_allocator(allocator) -> Callable:
    if callable(allocator):
        return allocator
    try:
        return _ALLOCATORS[allocator]
    except KeyError:
        raise ValueError(
            f"fleet allocator {allocator!r} unknown; closed-form "
            f"choices are {sorted(_ALLOCATORS)} (search allocators "
            f"like pso/coordinate re-run the scheduler per fitness "
            f"evaluation and cannot be batched — use "
            f"repro_torch.core.multiserver for those)") from None


# -------------------------------------------------------------------------
# Per-cell event state (mode="event")
# -------------------------------------------------------------------------

class _Svc:
    """The minimal service view the planning stack needs (an ``.id``);
    built transiently per replan, never retained."""
    __slots__ = ("id",)

    def __init__(self, sid: int):
        self.id = sid


class _CellState:
    """One cell's half of the event loop — the ``_ServerTrack``
    semantics over scalars and short parallel lists instead of
    ``_ServiceState`` objects.  ``live`` maps id -> [arrival,
    abs_deadline, spectral_eff, steps_done] for admitted services whose
    generation is incomplete (insertion order == admission order ==
    ascending id, the scenario-order invariant every tie-break relies
    on); ``reserved`` holds (id, tx_end, bandwidth) for content still
    in the air."""

    __slots__ = ("idx", "cfg", "delay", "live", "reserved", "t_free",
                 "plan", "admitted_total", "replans")

    def __init__(self, idx: int, cfg: FleetCell, base_delay: DelayModel):
        self.idx = idx
        self.cfg = cfg
        self.delay = cfg.server(idx).delay_model(base_delay)
        self.live: Dict[int, list] = {}
        self.reserved: List[tuple] = []       # (id, tx_end, bandwidth)
        self.t_free = 0.0
        self.plan = None    # (t0, starts, batches, last_batch_of, alloc, next)
        self.admitted_total = 0
        self.replans = 0

    @property
    def rows(self) -> int:
        return len(self.live) + len(self.reserved)

    # -- execution --------------------------------------------------------

    def _complete(self, sid: int, t: float, bandwidth: float,
                  bits: float, quality: QualityModel,
                  metrics: FleetMetrics) -> None:
        arrival, absdl, se, steps = self.live.pop(sid)
        tx_dur = bits / max(bandwidth * se, 1e-12)
        tx_end = t + tx_dur
        self.reserved.append((sid, tx_end, bandwidth))
        gen = t - arrival
        e2e = gen + tx_dur
        deadline = absdl - arrival
        metrics.observe(quality.fid(steps),
                        steps > 0 and e2e <= deadline + _TIE, e2e)

    def execute_until(self, t_limit: float, bits: float,
                      quality: QualityModel,
                      metrics: FleetMetrics) -> None:
        """Run every batch starting strictly before ``t_limit``
        (committed batches always finish; one starting exactly at an
        arrival instant stays replannable — the online rule)."""
        if self.plan is None:
            return
        t0, starts, batches, last_of, alloc, nxt = self.plan
        while nxt < len(batches) and t0 + starts[nxt] < t_limit:
            batch = batches[nxt]
            end = t0 + starts[nxt] + self.delay.g(len(batch))
            for sid, _ in batch:
                st = self.live.get(sid)
                if st is None:
                    continue
                st[3] += 1
                if nxt == last_of[sid]:
                    self._complete(sid, end, alloc[sid], bits,
                                   quality, metrics)
            self.t_free = max(self.t_free, end)
            nxt += 1
        self.plan = (t0, starts, batches, last_of, alloc, nxt)

    # -- replanning -------------------------------------------------------

    def residual(self, t_free: float, new: Optional[tuple],
                 allocator: Callable, bits: float):
        """The residual planning inputs at ``t_free``: ids (pending +
        the candidate arrival last), residual budgets tau', offsets,
        doomed mask and the per-service allocation — the array form of
        ``_ServerTrack.residual_scenario`` + ``tau_prime_of``."""
        self.reserved = [r for r in self.reserved if r[1] > t_free]
        ids = list(self.live.keys())
        rows = [self.live[k] for k in ids]
        if new is not None:
            sid, arrival, deadline, se_new = new
            ids.append(sid)
            rows.append([arrival, arrival + deadline, se_new, 0])
        K = len(ids)
        rd = np.array([r[1] - t_free for r in rows], dtype=np.float64)
        se = np.array([r[2] for r in rows], dtype=np.float64)
        off = np.array([r[3] for r in rows], dtype=np.int64)
        B = self.cfg.bandwidth_hz
        reserved = sum(bw for _, _, bw in
                       sorted(self.reserved))      # id order, like states
        alloc = np.asarray(allocator(max(B - reserved, _B_FLOOR * B), se),
                           dtype=np.float64)
        taup = rd - bits / np.maximum(alloc * se, 1e-12)
        doomed = (off > 0) & (taup < 0)
        if alloc.shape != (K,):
            raise ValueError(f"the fleet allocator returned shape "
                             f"{alloc.shape} for {K} services")
        return ids, rows, taup, off, doomed, alloc

    def plan_cell(self, ids, taup, off, doomed, quality, engine: str,
                  t_star_max: int = 0):
        """One residual plan through the per-scenario engine dispatch
        (the vec/scalar path; the torch path batches across cells and
        materializes with ``best_level`` via the same call)."""
        tp = {k: float(t) for k, t in zip(ids, taup)}
        svcs = [_Svc(k) for k in ids]
        q = quality
        if off.any():
            q = _OffsetQuality(quality, [int(o) for o in off])
            q.doomed = {i for i in range(len(ids)) if doomed[i]}
        self.replans += 1
        if t_star_max > 0:   # winner level already known (batched search)
            return arrays.stacking_pass_vec(ids, tp, self.delay,
                                            t_star_max)
        return stacking_mod.stacking(svcs, tp, self.delay, q,
                                     engine=engine)

    def adopt(self, t0: float, plan, ids, rows, alloc, new_id: int,
              bits: float, quality, metrics) -> None:
        """Accept the arrival: install the plan, then settle
        partially-generated services it gives no further steps
        (transmit what they have, now)."""
        sid_new = new_id
        if sid_new not in self.live:
            i = ids.index(sid_new)
            self.live[sid_new] = rows[i]
            self.admitted_total += 1
        last_of: Dict[int, int] = {}
        for n, batch in enumerate(plan.batches):
            for k, _ in batch:
                last_of[k] = n
        alloc_by_id = {k: float(a) for k, a in zip(ids, alloc)}
        self.plan = (t0, plan.start_times, plan.batches, last_of,
                     alloc_by_id, 0)
        for k in sorted(self.live.keys()):
            st = self.live[k]
            if st[3] > 0 and plan.steps_completed.get(k, 0) == 0:
                self._complete(k, t0, alloc_by_id[k], bits, quality,
                               metrics)

    def flush(self, bits: float, quality: QualityModel,
              metrics: FleetMetrics) -> None:
        """End of horizon: run the remaining batches, then emit outage
        rows for services that never completed generation (the
        ``_collect_result`` T==0 rule)."""
        self.execute_until(math.inf, bits, quality, metrics)
        for sid in list(self.live.keys()):
            arrival, absdl, se, steps = self.live.pop(sid)
            metrics.observe(quality.fid(steps), False, 0.0)


def _project_new(sid: int, plan, t0: float, arrival: float,
                 deadline: float, se: float, alloc_of: float,
                 bits: float, quality: QualityModel) -> ServiceOutcome:
    """``online._project`` for the arriving service: the outcome it
    gets if the trial plan runs uninterrupted."""
    T = plan.steps_completed.get(sid, 0)
    if T > 0:
        t_done = 0.0
        for t_n, batch in zip(plan.start_times, plan.batches):
            if any(kk == sid for kk, _ in batch):
                t_done = t_n + plan.delay.g(len(batch))
        gen = (t0 + t_done) - arrival
        tx = bits / max(alloc_of * se, 1e-12)
    else:
        gen = tx = 0.0
    e2e = gen + tx
    return ServiceOutcome(
        id=sid, deadline=deadline, steps=T, gen_delay=gen, tx_delay=tx,
        e2e_delay=e2e, fid=quality.fid(T),
        met_deadline=(T > 0 and e2e <= deadline + _TIE))


# -------------------------------------------------------------------------
# The fleet simulation loop
# -------------------------------------------------------------------------

def _batched_replans(requests: List[dict], cells: List[_CellState],
                     quality, devices, replan_many: Callable) -> int:
    """Run every gathered replan request through ONE ``replan_many``
    call per distinct cell speed (rows of one call must share a delay
    model), writing ``best_level`` back into each request.  Returns the
    number of planner calls issued.  ``replan_many`` is the engine's
    (``torchplan.replan_many`` for ``engine="torch"``)."""
    by_delay: Dict[tuple, List[dict]] = {}
    for req in requests:
        d = cells[req["cell"]].delay
        by_delay.setdefault((d.a, d.b), []).append(req)
    calls = 0
    for (a, b), group in by_delay.items():
        Kmax = max(len(r["ids"]) for r in group)
        S = len(group)
        taup = np.zeros((S, Kmax), dtype=np.float64)
        off = np.zeros((S, Kmax), dtype=np.int64)
        dm = np.zeros((S, Kmax), dtype=bool)
        vd = np.zeros((S, Kmax), dtype=bool)
        for i, r in enumerate(group):
            k = len(r["ids"])
            taup[i, :k] = r["taup"]
            off[i, :k] = r["off"]
            dm[i, :k] = r["doomed"]
            vd[i, :k] = True
        res = replan_many(
            taup, delay=DelayModel(a=a, b=b), quality=quality,
            offsets=off, doomed=dm, valid=vd, devices=devices)
        calls += 1
        for i, r in enumerate(group):
            r["best_level"] = int(res.best_level[i])
    return calls


def _run_event(fleet: FleetScenario, cells: List[_CellState],
               allocator: Callable, admission: Optional[FleetAdmissionFn],
               delay: DelayModel, quality: QualityModel,
               metrics: FleetMetrics, engine: str,
               batched: Optional[Callable],
               devices) -> Tuple[int, int]:
    """Lockstep event rounds: round r handles each cell's r-th arrival
    (cells are independent, so per-cell order is the only order that
    matters).  ``batched`` is the engine's ``replan_many``, or None to
    plan cell by cell.  Returns (peak_live_rows, planner_calls)."""
    bits = fleet.content_bits
    streams = []
    next_id = 0
    order = []   # (arrival, cell) sorted -> global ids in arrival order
    for c in range(fleet.n_cells):
        t, dl, se = _sample_cell(fleet, fleet.cells[c].process,
                                 *_cell_rngs(fleet, c),
                                 0.0, fleet.horizon)
        streams.append((t, dl, se))
        order.extend((float(t[i]), c, i) for i in range(t.size))
    order.sort()
    ids_of = {}
    for arrival, c, i in order:           # global ids in (arrival, cell)
        ids_of[(c, i)] = next_id          # order -> per-cell ascending
        next_id += 1
    cursors = [0] * fleet.n_cells
    peak = 0
    planner_calls = 0
    while True:
        requests = []
        for c, cell in enumerate(cells):
            t, dl, se = streams[c]
            i = cursors[c]
            if i >= t.size:
                continue
            t_arr = float(t[i])
            sid = ids_of[(c, i)]
            cell.execute_until(t_arr, bits, quality, metrics)
            metrics.arrivals += 1
            cfg = fleet.cells[c]
            if cfg.capacity is not None and \
                    cell.admitted_total >= cfg.capacity:
                metrics.rejected += 1     # force-reject, no trial replan
                cursors[c] += 1
                continue
            t_free = max(t_arr, cell.t_free)
            new = (sid, t_arr, float(dl[i]), float(se[i]))
            ids, rows, taup, off, doomed, alloc = cell.residual(
                t_free, new, allocator, bits)
            requests.append(dict(
                cell=c, ids=ids, rows=rows, taup=taup, off=off,
                doomed=doomed, alloc=alloc, t_free=t_free, new=new,
                best_level=0))
            cursors[c] += 1
        if not requests:
            break
        if batched and requests:
            planner_calls += _batched_replans(requests, cells, quality,
                                              devices, batched)
        for req in requests:
            cell = cells[req["cell"]]
            if not batched:
                planner_calls += 1
            plan = cell.plan_cell(req["ids"], req["taup"], req["off"],
                                  req["doomed"], quality, engine,
                                  t_star_max=req["best_level"])
            sid, t_arr, deadline, se_new = req["new"]
            alloc_of = float(req["alloc"][req["ids"].index(sid)])
            admit = True
            if admission is not None:
                projected = _project_new(
                    sid, plan, req["t_free"], t_arr, deadline, se_new,
                    alloc_of, bits, quality)
                admit = bool(admission(req["cell"], projected))
            if admit:
                metrics.admitted += 1
                cell.adopt(req["t_free"], plan, req["ids"], req["rows"],
                           req["alloc"], sid, bits, quality, metrics)
            else:
                metrics.rejected += 1
        peak = max(peak, sum(cell.rows for cell in cells))
    for cell in cells:
        cell.flush(bits, quality, metrics)
    return peak, planner_calls


def _place_shared(fleet: FleetScenario, placement: str, times, busy,
                  queued, t0: float, t1: float) -> np.ndarray:
    """Route a shared-stream chunk to cells.  ``round_robin`` cycles;
    ``least_busy`` greedily picks the earliest-free least-loaded cell;
    ``rate_aware`` additionally weighs each cell's OWN arrival
    process's forecast load for the window (``mean_rate``), steering
    shared traffic away from cells about to be busy with local
    arrivals — the arrival-process-aware policy."""
    n = fleet.n_cells
    if placement == "round_robin":
        start = queued.sum()
        return (start + np.arange(times.size)) % n
    forecast = np.zeros(n)
    if placement == "rate_aware":
        span = max(t1 - t0, 1e-12)
        for c, cfg in enumerate(fleet.cells):
            if cfg.process is not None:
                forecast[c] = cfg.process.mean_rate(t0, t1) * span
    elif placement != "least_busy":
        raise ValueError(f"placement {placement!r} unknown; choose "
                         f"round_robin, least_busy or rate_aware")
    load = queued.astype(np.float64) + forecast
    out = np.empty(times.size, dtype=np.int64)
    for i, t in enumerate(times):
        c = int(np.lexsort((np.arange(n), load,
                            np.maximum(busy, t)))[0])
        out[i] = c
        load[c] += 1.0
    return out


def _run_epoch(fleet: FleetScenario, cells: List[_CellState],
               allocator: Callable, admission: Optional[FleetAdmissionFn],
               delay: DelayModel, quality: QualityModel,
               metrics: FleetMetrics, engine: str,
               batched: Optional[Callable], devices, epoch: float,
               placement: str) -> Tuple[int, int]:
    """Batch-window provisioning (module docstring): one plan per cell
    per epoch, all epochs' planning batched when the engine allows
    (``batched`` as in ``_run_event``)."""
    bits = fleet.content_bits
    rngs = [_cell_rngs(fleet, c) for c in range(fleet.n_cells)]
    shared_arr = np.random.default_rng([fleet.seed, fleet.n_cells])
    shared_attr = np.random.default_rng([fleet.seed, fleet.n_cells, 1])
    n_epochs = max(1, int(math.ceil(fleet.horizon / epoch)))
    busy = np.zeros(fleet.n_cells)
    next_id = 0
    peak = 0
    planner_calls = 0
    for e in range(n_epochs):
        t0, t1 = e * epoch, min((e + 1) * epoch, fleet.horizon)
        queues: List[list] = [[] for _ in range(fleet.n_cells)]
        for c in range(fleet.n_cells):
            t, dl, se = _sample_cell(fleet, fleet.cells[c].process,
                                     *rngs[c], t0, t1)
            for i in range(t.size):
                queues[c].append((float(t[i]), float(dl[i]),
                                  float(se[i])))
        if fleet.shared_process is not None:
            t, dl, se = _sample_cell(fleet, fleet.shared_process,
                                     shared_arr, shared_attr, t0, t1)
            homes = _place_shared(
                fleet, placement, t, busy,
                np.array([len(q) for q in queues]), t0, t1)
            for i in range(t.size):
                queues[int(homes[i])].append(
                    (float(t[i]), float(dl[i]), float(se[i])))
        peak = max(peak, sum(len(q) for q in queues)
                   + sum(len(cl.reserved) for cl in cells))
        requests = []
        for c, queue in enumerate(queues):
            if not queue:
                continue
            queue.sort()
            metrics.arrivals += len(queue)
            cfg = fleet.cells[c]
            if cfg.capacity is not None:
                room = cfg.capacity - cells[c].admitted_total
                if len(queue) > max(room, 0):
                    metrics.rejected += len(queue) - max(room, 0)
                    queue = queue[:max(room, 0)]
                    if not queue:
                        continue
            cell = cells[c]
            cell.admitted_total += len(queue)
            t_plan = max(float(busy[c]), queue[-1][0])
            cell.reserved = [r for r in cell.reserved if r[1] > t_plan]
            rd = np.array([arr + dl - t_plan for arr, dl, _ in queue])
            se = np.array([s for _, _, s in queue])
            B = cfg.bandwidth_hz
            reserved = sum(bw for _, _, bw in sorted(cell.reserved))
            alloc = np.asarray(allocator(
                max(B - reserved, _B_FLOOR * B), se), dtype=np.float64)
            taup = rd - bits / np.maximum(alloc * se, 1e-12)
            ids = list(range(next_id, next_id + len(queue)))
            next_id += len(queue)
            requests.append(dict(
                cell=c, ids=ids, queue=queue, taup=taup,
                off=np.zeros(len(queue), dtype=np.int64),
                doomed=np.zeros(len(queue), dtype=bool),
                alloc=alloc, t_plan=t_plan, best_level=0))
        if batched and requests:
            planner_calls += _batched_replans(requests, cells, quality,
                                              devices, batched)
        for req in requests:
            c = req["cell"]
            cell = cells[c]
            if not batched:
                planner_calls += 1
            plan = cell.plan_cell(req["ids"], req["taup"], req["off"],
                                  req["doomed"], quality, engine,
                                  t_star_max=req["best_level"])
            t_plan = req["t_plan"]
            ids, queue, alloc = req["ids"], req["queue"], req["alloc"]
            if admission is not None:
                keep = []
                for i, sid in enumerate(ids):
                    arr, dl, se_i = queue[i]
                    p = _project_new(sid, plan, t_plan, arr, dl, se_i,
                                     float(alloc[i]), bits, quality)
                    if admission(c, p):
                        keep.append(i)
                    else:
                        metrics.rejected += 1
                        cell.admitted_total -= 1
                if len(keep) != len(ids):
                    if not keep:
                        continue
                    ids = [ids[i] for i in keep]
                    queue = [queue[i] for i in keep]
                    se = np.array([q[2] for q in queue])
                    rd = np.array([arr + dl - t_plan
                                   for arr, dl, _ in queue])
                    B = fleet.cells[c].bandwidth_hz
                    reserved = sum(bw for _, _, bw in
                                   sorted(cell.reserved))
                    alloc = np.asarray(allocator(
                        max(B - reserved, _B_FLOOR * B), se),
                        dtype=np.float64)
                    taup = rd - bits / np.maximum(alloc * se, 1e-12)
                    plan = cell.plan_cell(
                        ids, taup,
                        np.zeros(len(ids), dtype=np.int64),
                        np.zeros(len(ids), dtype=bool),
                        quality, engine, t_star_max=0)
                    planner_calls += 1
            metrics.admitted += len(ids)
            # plans run to completion: finalize every outcome now
            ends: Dict[int, float] = {}
            t_last = 0.0
            for t_n, batch in zip(plan.start_times, plan.batches):
                end = t_n + plan.delay.g(len(batch))
                t_last = max(t_last, end)
                for k, _ in batch:
                    ends[k] = end
            for i, sid in enumerate(ids):
                arr, dl, se_i = queue[i]
                T = plan.steps_completed.get(sid, 0)
                if T > 0:
                    gen_end = t_plan + ends[sid]
                    tx = bits / max(float(alloc[i]) * se_i, 1e-12)
                    e2e = (gen_end - arr) + tx
                    cell.reserved.append((sid, gen_end + tx,
                                          float(alloc[i])))
                    metrics.observe(quality.fid(T),
                                    e2e <= dl + _TIE, e2e)
                else:
                    metrics.observe(quality.fid(0), False, 0.0)
            busy[c] = max(t_plan + t_last, float(busy[c]))
    return peak, planner_calls


def simulate_fleet(fleet: FleetScenario, *,
                   allocator: Union[str, Callable] = "equal",
                   admission: Optional[FleetAdmissionFn] = None,
                   delay: Optional[DelayModel] = None,
                   quality: Optional[QualityModel] = None,
                   mode: str = "epoch",
                   epoch: Optional[float] = None,
                   placement: str = "least_busy",
                   engine: Optional[str] = None,
                   devices=None,
                   reservoir: int = 4096) -> FleetResult:
    """Simulate the fleet end-to-end with streaming metrics (module
    docstring for the two modes).

    ``allocator`` is a closed-form P1 split (``"equal"``/``"inv_se"``
    or a callable ``(available_hz, spectral_effs) -> alloc``);
    ``admission`` an optional per-cell policy ``(cell, projected
    ServiceOutcome) -> bool`` (None = admit all); ``engine`` the
    planner engine (``repro_torch.core.arrays`` registry; an engine
    exposing ``replan_many`` — ``"torch"``, on ``torchplan.device_scope``'s
    device — gets every concurrent replan batched into one call,
    optionally sharded across devices via ``devices``, which an engine
    without batching drops, as the reference does);
    ``placement`` routes the fleet's shared stream, if any.  ``epoch``
    defaults to ``horizon / 64``.
    """
    delay = delay if delay is not None else DelayModel()
    quality = quality if quality is not None else PowerLawFID()
    alloc_fn = _resolve_allocator(allocator)
    eng = arrays.resolve_engine(engine)
    impl = arrays.engine_impl(eng)
    batched = getattr(impl, "replan_many", None)
    if mode not in ("event", "epoch"):
        raise ValueError(f"mode must be 'event' or 'epoch', got {mode!r}")
    if not isinstance(quality, PowerLawFID) and batched:
        batched = None       # batched scoring is PowerLawFID-only
    metrics = FleetMetrics(seed=fleet.seed, reservoir=reservoir)
    cells = [_CellState(c, cfg, delay)
             for c, cfg in enumerate(fleet.cells)]
    if mode == "event":
        if fleet.shared_process is not None:
            raise ValueError("mode='event' runs per-cell arrival "
                             "processes only; shared streams need "
                             "mode='epoch' (where placement applies)")
        peak, calls = _run_event(fleet, cells, alloc_fn, admission,
                                 delay, quality, metrics, eng, batched,
                                 devices)
    else:
        width = epoch if epoch is not None else fleet.horizon / 64.0
        if not width > 0:
            raise ValueError(f"epoch width must be > 0, got {width}")
        peak, calls = _run_epoch(fleet, cells, alloc_fn, admission,
                                 delay, quality, metrics, eng, batched,
                                 devices, width, placement)
    return FleetResult(
        mode=mode, engine=eng,
        arrivals=metrics.arrivals, admitted=metrics.admitted,
        rejected=metrics.rejected, completed=metrics.completed,
        mean_fid=metrics.mean_fid, outage_rate=metrics.outage_rate,
        reject_rate=metrics.reject_rate,
        delay_p50=metrics.delays.percentile(50),
        delay_p95=metrics.delays.percentile(95),
        delay_p99=metrics.delays.percentile(99),
        peak_live_rows=peak,
        replans=sum(c.replans for c in cells),
        planner_calls=calls)


# -------------------------------------------------------------------------
# Cross-validation against the object-graph simulator
# -------------------------------------------------------------------------

def fleet_to_scenario(fleet: FleetScenario
                      ) -> Tuple[Scenario, List[int]]:
    """Materialize a (small) fleet into a multi-server ``Scenario`` +
    per-service cell assignment, for cross-checking ``simulate_fleet``
    against ``simulate_online_multi``: same single-window arrival
    sampling as ``mode="event"``, global service ids in (arrival,
    cell) order — per-cell ids ascend with arrival time, the invariant
    both simulators' tie-breaks share.  Pin the returned assignment
    through a placement function and the two simulators must agree on
    mean FID within 1e-9 (tests/test_fleet.py; the `fleet` benchmark
    suite gates it)."""
    if fleet.shared_process is not None:
        raise ValueError("fleet_to_scenario covers per-cell processes "
                         "only (shared streams are epoch-mode)")
    pool = []
    for c in range(fleet.n_cells):
        t, dl, se = _sample_cell(fleet, fleet.cells[c].process,
                                 *_cell_rngs(fleet, c),
                                 0.0, fleet.horizon)
        pool.extend((float(t[i]), c, float(dl[i]), float(se[i]))
                    for i in range(t.size))
    pool.sort(key=lambda r: (r[0], r[1]))
    services, assignment = [], []
    for sid, (arrival, c, deadline, se) in enumerate(pool):
        services.append(ServiceRequest(
            id=sid, deadline=deadline, spectral_eff=se,
            arrival=arrival))
        assignment.append(c)
    servers = [cfg.server(c) for c, cfg in enumerate(fleet.cells)]
    scn = Scenario(services=services, content_bits=fleet.content_bits,
                   total_bandwidth_hz=sum(s.bandwidth_hz
                                          for s in servers),
                   servers=servers)
    return scn, assignment
