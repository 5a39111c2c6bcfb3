"""Shared facade machinery: one resolution path for the common kwargs.

Every facade (``Provisioner``, ``OnlineProvisioner``,
``MultiServerProvisioner``, ``FleetProvisioner``) derives from
``BaseProvisioner`` and accepts the same keyword set:

    engine=    planning-engine pin ("vec"/"scalar"/"torch",
               repro_torch.core.arrays; None = process default)
    device=    where the facade's torch work runs: the "torch" planner
               engine (``torchplan.device_scope``) and a workload
               named by string; "cuda" by default, "cpu" on request
    seed=      one deterministic seed: injected into the allocator's
               kwargs when its signature takes ``seed`` and used as the
               default ``torch.Generator`` for workload execution
               (fleet scenarios adopt it as their arrival seed)
    execute=   default execution mode for ``run()``:
               False/None (analytic), True (one-shot workload
               execution), "open" (ExecutionLoop, no replanning) or
               "closed" (ExecutionLoop with drift-triggered replanning)

``execute_kwargs`` (``Provisioner`` and ``OnlineProvisioner``, the two
facades that execute) passes loop tuning through to ``execute_plan``
(``window``, ``drift_tol``, ...) plus ``exec_engine=`` to pick the
denoising session engine (``"dict"`` / ``"bucketed"``).  The reference's
``devices=`` (sharded jax planning) is taken only where it reaches the
batched planner, ``FleetProvisioner``, and raises there: the port does
not shard across cards.

``provision(scenario, ...)`` is the single front door: it dispatches on
scenario shape (fleet / multi-server / online / static) and returns
exactly what the matching facade's ``run()`` returns.

The port of ``repro.api.base``.  Its deprecated positional shims are
not ported: the port has no callers of the old signatures.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import arrays
from repro_torch.core.torchplan import device_scope

EXECUTE_MODES = (None, False, True, "open", "closed")


def jsonable(v):
    """Recursively convert numpy scalars/arrays so ``to_dict`` output
    survives ``json.dumps`` round-trips."""
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, np.ndarray):
        return [jsonable(x) for x in v.tolist()]
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def report_dict(kind: str, *, mean_fid: float, outage_rate: float,
                makespan: Optional[float] = None,
                components: Optional[Dict[str, str]] = None,
                telemetry: Optional[dict] = None, **extra) -> dict:
    """The common report ``to_dict`` protocol: every report kind carries
    at least kind / mean_fid / outage_rate / makespan / components /
    telemetry (JSON-serializable)."""
    out = {
        "kind": kind,
        "mean_fid": None if mean_fid is None or np.isnan(mean_fid)
        else float(mean_fid),
        "outage_rate": float(outage_rate),
        "makespan": None if makespan is None else float(makespan),
        "components": {k: str(v) for k, v in (components or {}).items()},
        "telemetry": jsonable(telemetry or {}),
    }
    out.update(jsonable(extra))
    return out


def display_name(spec: Any) -> str:
    """Human-readable name of a component: the string itself, or a
    callable/instance's best-effort name (report headers use this)."""
    if isinstance(spec, str):
        return spec
    return getattr(spec, "__name__", type(spec).__name__)


def resolve(table: Dict[str, Any], spec: Any, kind: str) -> Any:
    """Look a name up in one of the port's component dicts; pass a
    callable or instance through."""
    if not isinstance(spec, str):
        return spec
    if spec not in table:
        raise ValueError(f"unknown {kind} {spec!r}; expected one of "
                         f"{sorted(table)}")
    return table[spec]


class BaseProvisioner:
    """Common constructor surface and helpers of the four facades."""

    def __init__(self, scenario, *, engine: Optional[str] = None,
                 device="cuda", seed: Optional[int] = None,
                 execute=None, execute_kwargs: Optional[dict] = None):
        self.scenario = scenario
        if engine is not None:           # fail fast on an unknown name
            arrays.resolve_engine(engine)
        self.engine = engine
        self.device = device
        self.seed = seed
        self.execute_default = self._check_execute(execute)
        self.execute_kwargs = dict(execute_kwargs or {})

    @staticmethod
    def _check_execute(execute):
        if execute not in EXECUTE_MODES:
            raise ValueError(
                f"execute must be one of {EXECUTE_MODES}, got "
                f"{execute!r}")
        return execute

    def _resolve_execute(self, execute):
        """run(execute=None) falls back to the constructor default."""
        if execute is None:
            return self.execute_default
        return self._check_execute(execute)

    @contextlib.contextmanager
    def _planning(self):
        """The planner engine and its device, for one planning stage."""
        with arrays.engine_scope(self.engine), device_scope(self.device):
            yield

    def _seeded_kwargs(self, allocator, kwargs: Optional[dict]) -> dict:
        """Inject ``seed=`` into the allocator's kwargs when its
        signature (``allocator`` is the resolved callable) takes one
        and the caller did not pin it."""
        kwargs = dict(kwargs or {})
        if self.seed is None or "seed" in kwargs:
            return kwargs
        try:
            params = inspect.signature(allocator).parameters
        except (TypeError, ValueError):
            params = {}
        if "seed" in params:
            kwargs["seed"] = int(self.seed)
        return kwargs

    def _resolve_generator(self, generator: Optional[torch.Generator]):
        """Default ``torch.Generator`` for workload execution from
        ``seed=`` (a CPU generator, as the workloads draw on)."""
        if generator is not None or self.seed is None:
            return generator
        return torch.Generator().manual_seed(int(self.seed))


def provision(scenario, **kwargs):
    """The unified front door: dispatch on scenario shape and run.

    * ``FleetScenario`` -> ``FleetProvisioner.run``
    * multi-server ``Scenario`` with arrivals, admission or handoff
      -> ``MultiServerProvisioner.run_online``
    * multi-server ``Scenario`` -> ``MultiServerProvisioner.run``
    * arrivals over time or ``admission=`` -> ``OnlineProvisioner.run``
    * static single-server ``Scenario`` -> ``Provisioner.run``

    Remaining keyword arguments split between the chosen facade's
    constructor and its ``run()``; the result is exactly what calling
    that facade directly returns.
    """
    from repro_torch.api.fleet import FleetProvisioner
    from repro_torch.api.multiserver import MultiServerProvisioner
    from repro_torch.api.online import OnlineProvisioner
    from repro_torch.api.provisioner import Provisioner
    from repro_torch.core.fleet import FleetScenario

    kw = dict(kwargs)

    def split(*run_keys):
        return {k: kw.pop(k) for k in run_keys if k in kw}

    if isinstance(scenario, FleetScenario):
        run_kw = split("mode", "epoch", "placement", "reservoir")
        return FleetProvisioner(scenario, **kw).run(**run_kw)

    dynamic = (not scenario.is_static or "admission" in kw
               or "admission_kwargs" in kw or "handoff" in kw
               or "online_placement" in kw)
    if scenario.n_servers > 1:
        if dynamic:
            run_kw = split("admission", "online_placement",
                           "admission_kwargs", "handoff", "validate")
            return MultiServerProvisioner(scenario, **kw) \
                .run_online(**run_kw)
        run_kw = split("assignment", "validate")
        return MultiServerProvisioner(scenario, **kw).run(**run_kw)
    if dynamic:
        run_kw = split("generator", "validate", "execute", "latents")
        return OnlineProvisioner(scenario, **kw).run(**run_kw)
    run_kw = split("generator", "execute", "timed", "calibrate", "refit",
                   "validate", "latents")
    return Provisioner(scenario, **kw).run(**run_kw)
