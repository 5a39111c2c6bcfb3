"""Fleet front end: population-scale provisioning by name.

    from repro_torch.api import FleetProvisioner, make_fleet_scenario

    fleet = make_fleet_scenario(n_cells=500, horizon=200.0,
                                arrival="diurnal",
                                arrival_kwargs={"base_rate": 0.4},
                                bandwidth_hz=1.2e6, seed=7)
    report = FleetProvisioner(fleet, allocator="inv_se",
                              engine="torch").run(mode="epoch")
    print(report.summary())

``make_fleet_scenario`` builds a ``core/fleet.py`` ``FleetScenario``
from names: the registry ``ARRIVALS`` maps traffic-model names
("poisson", "diurnal", "flash_crowd", "inhomogeneous", "trace") to the
``core/traffic.py`` constructors, so scenario configs stay plain
strings + kwargs like every other pipeline component.  Cell
hardware (bandwidth, speed, capacity) and arrival specs accept either
one value for the whole fleet or one per cell; ``correlation > 0``
draws per-cell Poisson rates from the log-normal shared-factor model
(``traffic.correlated_rates``) instead of a uniform rate.

``FleetProvisioner`` wraps ``simulate_fleet`` the way
``OnlineProvisioner`` wraps ``simulate_online``: ``run`` returns a
``FleetReport`` whose ``summary()`` is one line per fleet run —
streaming aggregates only, never per-service rows.  With
``engine="torch"`` every concurrent replan of the fleet goes to
``torchplan.replan_many`` on the facade's ``device``.

The port of ``repro.api.fleet``; the arrival processes are registered
under the reference's names and aliases.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from repro_torch.api.base import BaseProvisioner, report_dict
from repro_torch.api.registry import (ARRIVALS, display_name,
                                      register_arrival)
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.fleet import (FleetCell, FleetResult, FleetScenario,
                                    simulate_fleet)
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.traffic import (ArrivalProcess, DiurnalPoisson,
                                      FlashCrowd, InhomogeneousPoisson,
                                      PoissonProcess, TraceArrivals,
                                      correlated_rates, load_trace)

# Each entry is a *factory* (name -> constructor); make_fleet_scenario
# instantiates it with the user's kwargs, so configs serialize as
# ("diurnal", {"base_rate": 0.4}) rather than live objects.
register_arrival("poisson", PoissonProcess, aliases=("homogeneous",))
register_arrival("inhomogeneous", InhomogeneousPoisson)
register_arrival("diurnal", DiurnalPoisson)
register_arrival("flash_crowd", FlashCrowd, aliases=("flash",))
register_arrival("trace", load_trace, aliases=("csv", "json"))
register_arrival("trace_times", TraceArrivals)


ArrivalSpec = Union[None, str, ArrivalProcess, Callable]


def _make_process(spec: ArrivalSpec, kwargs: Optional[dict]) -> \
        Optional[ArrivalProcess]:
    """One cell's arrival process from a spec: a name is looked up in
    ARRIVALS and called with ``kwargs``; an existing process (anything
    with ``sample``) passes through; ``None`` means no local load
    (shared-stream-only cell)."""
    if spec is None:
        return None
    obj = ARRIVALS.resolve(spec)
    if not isinstance(obj, type) and hasattr(obj, "sample"):
        if kwargs:
            raise ValueError(
                f"arrival process {display_name(spec)!r} is already "
                f"constructed; arrival_kwargs={kwargs} would be ignored")
        return obj
    return obj(**(kwargs or {}))


def _with_rate(spec: ArrivalSpec, kwargs: Optional[dict],
               value: float) -> Optional[dict]:
    """Apply the ``rate=`` sugar to one cell's kwargs under the
    factory's own parameter name (``rate`` for Poisson, ``base_rate``
    for diurnal/flash-crowd curves); loud errors for factories that
    take no rate and for conflicts with explicit kwargs."""
    if spec is None:
        return kwargs
    obj = ARRIVALS.resolve(spec)
    if not isinstance(obj, type) and hasattr(obj, "sample"):
        raise ValueError(
            f"rate= cannot be applied to the already constructed "
            f"arrival process {display_name(spec)!r}")
    try:
        params = inspect.signature(obj).parameters
    except (TypeError, ValueError):  # builtins without signatures
        params = {}
    name = next((p for p in ("rate", "base_rate") if p in params), None)
    if name is None:
        raise ValueError(
            f"arrival {display_name(spec)!r} takes neither rate= nor "
            f"base_rate=; configure it via arrival_kwargs instead")
    if kwargs and name in kwargs:
        raise ValueError(
            f"{name}={kwargs[name]} in arrival_kwargs conflicts with "
            f"the fleet-level rate= sugar")
    return dict(kwargs or {}, **{name: value})


def _per_cell(value, n: int, name: str) -> List:
    """Broadcast a scalar fleet-wide setting to ``n`` cells, or
    validate a per-cell sequence's length."""
    if isinstance(value, (list, tuple, np.ndarray)):
        if len(value) != n:
            raise ValueError(f"{name} has {len(value)} entries for "
                             f"{n} cells")
        return list(value)
    return [value] * n


def make_fleet_scenario(n_cells: int, horizon: float, *,
                        arrival: Union[ArrivalSpec, Sequence] = "poisson",
                        arrival_kwargs: Optional[Union[dict, Sequence]]
                        = None,
                        rate: Optional[Union[float, Sequence[float]]]
                        = None,
                        correlation: float = 0.0,
                        spread: float = 0.3,
                        bandwidth_hz: Union[float, Sequence[float]]
                        = 1.0e6,
                        speed: Union[float, Sequence[float]] = 1.0,
                        capacity: Union[None, int, Sequence] = None,
                        seed: int = 0,
                        deadline_range=(1.0, 3.0),
                        spectral_eff_range=(1.0, 4.0),
                        content_bits: float = 2.0e6,
                        shared_arrival: ArrivalSpec = None,
                        shared_kwargs: Optional[dict] = None
                        ) -> FleetScenario:
    """Build a ``FleetScenario`` from names.

    ``arrival`` / ``arrival_kwargs`` / ``bandwidth_hz`` / ``speed`` /
    ``capacity`` each take one value for the whole fleet or a per-cell
    sequence.  ``rate`` is sugar for the rate-parameterized factories
    (it binds to ``rate`` for Poisson, ``base_rate`` for the
    diurnal/flash-crowd curves): a scalar (every cell), a per-cell
    sequence, or — with ``correlation > 0`` — the
    mean of the correlated log-normal rate model
    (``traffic.correlated_rates`` on substream ``[seed, "rates"]``;
    ``spread`` is its dispersion).  ``shared_arrival`` adds the
    fleet-wide stream that ``simulate_fleet(placement=...)`` routes.
    """
    if n_cells < 1:
        raise ValueError(f"n_cells must be >= 1, got {n_cells}")
    specs = _per_cell(arrival, n_cells, "arrival") \
        if isinstance(arrival, (list, tuple)) else [arrival] * n_cells
    if isinstance(arrival_kwargs, (list, tuple)):
        kwlist = _per_cell(arrival_kwargs, n_cells, "arrival_kwargs")
    else:
        kwlist = [arrival_kwargs] * n_cells

    if rate is not None:
        if correlation > 0.0:
            if not np.isscalar(rate):
                raise ValueError("correlation needs a scalar base rate")
            rng = np.random.default_rng([seed, 0x7A7E])
            rates = correlated_rates(rng, n_cells, float(rate),
                                     correlation=correlation,
                                     spread=spread)
        else:
            rates = np.asarray(_per_cell(rate, n_cells, "rate"),
                               dtype=float)
        kwlist = [_with_rate(specs[c], kw, float(rates[c]))
                  for c, kw in enumerate(kwlist)]
    elif correlation > 0.0:
        raise ValueError("correlation requires rate= (the base rate "
                         "the correlated per-cell rates are drawn "
                         "around)")

    bws = _per_cell(bandwidth_hz, n_cells, "bandwidth_hz")
    spds = _per_cell(speed, n_cells, "speed")
    caps = _per_cell(capacity, n_cells, "capacity")
    cells = tuple(
        FleetCell(bandwidth_hz=float(bws[c]), speed=float(spds[c]),
                  capacity=caps[c],
                  process=_make_process(specs[c], kwlist[c]))
        for c in range(n_cells))
    return FleetScenario(
        cells=cells, horizon=horizon, seed=seed,
        deadline_range=tuple(deadline_range),
        spectral_eff_range=tuple(spectral_eff_range),
        content_bits=content_bits,
        shared_process=_make_process(shared_arrival, shared_kwargs))


# -- report + facade ------------------------------------------------------

@dataclasses.dataclass
class FleetReport:
    """One fleet run: the scenario, the streaming aggregates, and the
    component names that produced them."""
    fleet: FleetScenario
    result: FleetResult
    allocator_name: str = ""
    admission_name: str = ""
    placement_name: str = ""

    @property
    def mean_fid(self) -> float:
        return self.result.mean_fid

    @property
    def outage_rate(self) -> float:
        return self.result.outage_rate

    @property
    def reject_rate(self) -> float:
        return self.result.reject_rate

    def summary(self) -> str:
        r = self.result
        return (f"[fleet x{self.fleet.n_cells} {r.mode}/{r.engine}] "
                f"allocator={self.allocator_name} "
                f"admission={self.admission_name or 'admit_all'} | "
                f"arrivals={r.arrivals} admitted={r.admitted} "
                f"rejected={r.rejected} | mean_fid={r.mean_fid:.3f} "
                f"outage={r.outage_rate:.3%} "
                f"p95_delay={r.delay_p95:.3f}s | "
                f"peak_rows={r.peak_live_rows} "
                f"planner_calls={r.planner_calls}")

    def to_dict(self) -> dict:
        """Common report protocol (``api/base.py``'s ``report_dict``)."""
        r = self.result
        return report_dict(
            "fleet", mean_fid=self.mean_fid,
            outage_rate=self.outage_rate, makespan=self.fleet.horizon,
            components={"allocator": self.allocator_name,
                        "admission": self.admission_name or "admit_all",
                        "placement": self.placement_name},
            telemetry={"arrivals": r.arrivals, "admitted": r.admitted,
                       "rejected": r.rejected, "delay_p95": r.delay_p95,
                       "peak_live_rows": r.peak_live_rows,
                       "planner_calls": r.planner_calls,
                       "mode": r.mode, "engine": r.engine},
            reject_rate=self.reject_rate,
            n_cells=self.fleet.n_cells)


class FleetProvisioner(BaseProvisioner):
    """``simulate_fleet`` behind names — the population-scale sibling
    of ``OnlineProvisioner``.  ``engine``/``device``/``seed``/``execute``
    are the shared facade kwargs (``api/base.py``); ``seed=`` re-seeds
    the fleet's arrival streams, ``devices=`` goes to ``simulate_fleet``
    (the torch engine's batched replans sharded across devices; an
    engine without batching drops it), and
    execution on a real model is not defined at fleet scale
    (``execute=`` truthy raises).

    ``admission`` is a fleet policy ``(cell_index, projected
    ServiceOutcome) -> bool`` or ``None`` (admit all); the single-cell
    ADMISSIONS dict is not reused because fleet policies see the cell,
    not the global state dict.
    """

    def __init__(self, fleet: FleetScenario, *,
                 allocator: Union[str, Callable] = "equal",
                 admission: Optional[Callable] = None,
                 delay: Optional[DelayModel] = None,
                 quality: Optional[QualityModel] = None,
                 engine: Optional[str] = None, device="cuda",
                 devices=None, seed: Optional[int] = None,
                 execute=None):
        if seed is not None:
            fleet = dataclasses.replace(fleet, seed=int(seed))
        super().__init__(fleet, engine=engine, device=device,
                         seed=seed, execute=execute)
        self.fleet = fleet
        self.devices = devices
        self.allocator = allocator
        self.admission = admission
        self.delay = delay
        self.quality = quality

    def run(self, mode: str = "epoch", *,
            epoch: Optional[float] = None,
            placement: str = "least_busy",
            reservoir: int = 4096, execute=None) -> FleetReport:
        if self._resolve_execute(execute):
            raise NotImplementedError(
                "fleet runs are streaming aggregates over thousands of "
                "simulated cells; execution on a real model is per "
                "cell/scenario (Provisioner execute=)")
        with self._planning():
            result = simulate_fleet(
                self.fleet, allocator=self.allocator,
                admission=self.admission, delay=self.delay,
                quality=self.quality, mode=mode, epoch=epoch,
                placement=placement, engine=self.engine,
                devices=self.devices, reservoir=reservoir)
        return FleetReport(
            fleet=self.fleet, result=result,
            allocator_name=display_name(self.allocator),
            admission_name=(display_name(self.admission)
                            if self.admission is not None else ""),
            placement_name=placement)
