"""String-keyed registries behind the port's provisioner API.

The port of ``repro.api.registry``, whole.  Seven registries --
schedulers (P2 solvers), allocators (P1 solvers), workloads (step
executors), admissions (online accept/reject policies), placements
(multi-server assignment strategies), arrivals (traffic processes for
fleet simulation) and executors (stepwise session factories for
closed-loop plan execution, ``repro_torch.api.execution``) -- so every
pipeline component is addressable by name
(``Provisioner(scn, scheduler="stacking", allocator="pso")``,
``OnlineProvisioner(scn, admission="deadline_feasible")``,
``MultiServerProvisioner(scn, placement="greedy_fid")``) and new
variants plug in with a one-line decorator:

    @register_scheduler("my_sched")
    def my_sched(services, tau_prime, delay, quality): ...

The entry modules register on import (``repro_torch.api`` imports them
all); the names are the reference's, its ``*_jax`` entries read as
``*_torch``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence


class Registry:
    """Name -> object map with decorator registration and helpful errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str, obj: Any = None,
                 *, aliases: Sequence[str] = ()) -> Any:
        """Register ``obj`` (or decorate) under ``name`` and any aliases."""
        def deco(o):
            for n in (name, *aliases):
                if n in self._items:
                    raise ValueError(
                        f"{self.kind} '{n}' is already registered")
                self._items[n] = o
            return o
        return deco(obj) if obj is not None else deco

    def get(self, name: str) -> Any:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} '{name}'; registered: "
                f"{', '.join(sorted(self._items)) or '(none)'}") from None

    def resolve(self, spec: Any) -> Any:
        """Look up a string; pass anything else (callable/instance) through."""
        return self.get(spec) if isinstance(spec, str) else spec

    def names(self) -> List[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items


def display_name(spec: Any) -> str:
    """Human-readable name for a registry spec: the string itself, or a
    callable/instance's best-effort name (report headers use this)."""
    if isinstance(spec, str):
        return spec
    return getattr(spec, "__name__", type(spec).__name__)


SCHEDULERS = Registry("scheduler")
ALLOCATORS = Registry("allocator")
WORKLOADS = Registry("workload")
ADMISSIONS = Registry("admission")
PLACEMENTS = Registry("placement")
ARRIVALS = Registry("arrival process")
EXECUTORS = Registry("executor")


def register_scheduler(name: str, obj: Any = None, **kw):
    return SCHEDULERS.register(name, obj, **kw)


def register_allocator(name: str, obj: Any = None, **kw):
    return ALLOCATORS.register(name, obj, **kw)


def register_workload(name: str, obj: Any = None, **kw):
    return WORKLOADS.register(name, obj, **kw)


def register_admission(name: str, obj: Any = None, **kw):
    return ADMISSIONS.register(name, obj, **kw)


def register_placement(name: str, obj: Any = None, **kw):
    return PLACEMENTS.register(name, obj, **kw)


def register_arrival(name: str, obj: Any = None, **kw):
    return ARRIVALS.register(name, obj, **kw)


def register_executor(name: str, obj: Any = None, **kw):
    return EXECUTORS.register(name, obj, **kw)


def get_scheduler(name: str) -> Callable:
    return SCHEDULERS.get(name)


def get_allocator(name: str) -> Callable:
    return ALLOCATORS.get(name)


def get_workload(name: str) -> Any:
    return WORKLOADS.get(name)


def get_admission(name: str) -> Callable:
    return ADMISSIONS.get(name)


def get_placement(name: str) -> Callable:
    return PLACEMENTS.get(name)


def get_arrival(name: str) -> Callable:
    return ARRIVALS.get(name)


def get_executor(name: str) -> Callable:
    return EXECUTORS.get(name)


def list_schedulers() -> List[str]:
    return SCHEDULERS.names()


def list_allocators() -> List[str]:
    return ALLOCATORS.names()


def list_workloads() -> List[str]:
    return WORKLOADS.names()


def list_admissions() -> List[str]:
    return ADMISSIONS.names()


def list_placements() -> List[str]:
    return PLACEMENTS.names()


def list_arrivals() -> List[str]:
    return ARRIVALS.names()


def list_executors() -> List[str]:
    return EXECUTORS.names()
