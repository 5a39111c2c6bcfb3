"""Closed-loop plan execution behind the ``EXECUTORS`` registry.

The port of ``repro.api.execution``.  ``EXECUTORS`` maps executor names
to *session factories*: a session is a stepwise execution handle
(``run_batch`` / ``retarget`` / ``finish``, see ``core/execution.py``)
that ``ExecutionLoop`` drives batch by batch, measuring wall-clock,
refitting the delay model and replanning on drift.  A caller may pass
a factory of its own in place of a name.

Entries:

  * ``"diffusion"``  -- ``BatchDenoisingExecutor`` sessions (the DDIM
                        U-Net with the groupnorm_silu kernel), on the
                        ``"dict"`` or ``"bucketed"`` engine
  * ``"llm_decode"`` -- ``ServingEngine`` decode sessions
  * ``"simulated"``  -- synthetic wall-clock from a hidden true
                        ``DelayModel``; takes ``true_delay=``,
                        ``noise=``, ``seed=`` via ``executor_kwargs``

Entry points:

  * ``execute_plan``   -- run a (scenario, plan, allocation) on a
                          workload's executor, open or closed loop
  * ``execute_report`` -- the same, resolving everything from a
                          ``ProvisionReport``
  * ``replay_result``  -- re-run an online result's committed batch
                          sequence on a real executor (open loop)

Randomness is a ``torch.Generator`` (``generator=``) in place of the
reference's jax key; a diffusion session also takes ``latents=``
through ``executor_kwargs``.
"""

from __future__ import annotations

import functools
from typing import Optional

from repro_torch import obs
from repro_torch.api.protocols import WorkloadOutput
from repro_torch.api.registry import (ALLOCATORS, EXECUTORS, SCHEDULERS,
                                      register_executor)
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.execution import (ExecutionLoop, ExecutionResult,
                                        SimulatedSession)
from repro_torch.core.plan import BatchPlan


@register_executor("diffusion")
@register_executor("llm_decode")
def _workload_session(workload, plan, generator, **kw):
    """The workload's own session; ``DecodeWorkload.open_session``
    refuses an ``exec_engine`` other than the dict one."""
    return workload.open_session(plan, generator, **kw)


@register_executor("simulated")
def _simulated_session(workload, plan, generator, *,
                       true_delay: DelayModel, noise: float = 0.0,
                       seed: int = 0, exec_engine: Optional[str] = None):
    if exec_engine not in (None, "dict"):
        raise ValueError(f"simulated executor has no "
                         f"exec_engine={exec_engine!r} (the bucketed "
                         f"engine is diffusion-only)")
    return SimulatedSession(plan, true_delay, noise=noise, seed=seed)


def make_session(workload, plan: BatchPlan, generator=None, *,
                 executor=None, executor_kwargs: Optional[dict] = None):
    """Open a stepwise execution session.  ``executor`` is an
    ``EXECUTORS`` name or a factory; ``None`` uses the workload's own
    name (so a ``DiffusionWorkload`` opens a ``DenoiseSession`` etc.)."""
    if executor is None:
        executor = getattr(workload, "name", None)
        if executor is None:
            raise ValueError(
                "no executor: attach a named workload or pass "
                f"executor= (registered: {EXECUTORS.names()})")
    factory = EXECUTORS.resolve(executor)
    with obs.span("session.open"):
        return factory(workload, plan, generator, **(executor_kwargs or {}))


def execute_plan(scenario, plan: BatchPlan, alloc, workload=None, *,
                 mode: str = "closed", generator=None, scheduler="stacking",
                 allocator="inv_se", delay: Optional[DelayModel] = None,
                 quality=None, engine: Optional[str] = None,
                 validate: bool = True, executor=None,
                 executor_kwargs: Optional[dict] = None,
                 window: int = 32, drift_tol: float = 0.25,
                 min_batches: int = 3, max_replans: int = 8,
                 headroom: float = 1.0,
                 exec_engine: Optional[str] = None) -> ExecutionResult:
    """Execute a planned batch schedule on a real (or simulated)
    executor.  ``mode="open"`` runs the plan as given (telemetry +
    rolling refit only); ``mode="closed"`` replans mid-flight through
    the offset-aware path when measured delay drifts (``drift_tol``,
    ``min_batches``, ``max_replans``, ``headroom`` tune the loop).
    ``exec_engine`` picks the denoising session engine (``"dict"`` /
    ``"bucketed"``; ``None`` = the executor's default) and is recorded
    in the result telemetry.  ``engine`` pins the planning engine of
    every replan (``repro_torch.core.arrays``; ``"torch"`` runs on
    ``torchplan.device_scope``'s device)."""
    if exec_engine is not None:
        executor_kwargs = dict(executor_kwargs or {})
        executor_kwargs.setdefault("exec_engine", exec_engine)
    with obs.span("execute") as sp:
        session = make_session(workload, plan, generator,
                               executor=executor,
                               executor_kwargs=executor_kwargs)
        loop = ExecutionLoop(
            scenario, plan, alloc, session, delay=delay, quality=quality,
            scheduler=SCHEDULERS.resolve(scheduler),
            allocator=ALLOCATORS.resolve(allocator),
            mode=mode, window=window, drift_tol=drift_tol,
            min_batches=min_batches, max_replans=max_replans,
            headroom=headroom, validate=validate, engine=engine,
            exec_engine=(executor_kwargs or {}).get("exec_engine"))
        result = loop.run()
        # the loop's clock: the sum of measured batch seconds, the time
        # its deadline verdicts and replans count
        sp.set(loop_clock_s=result.wall_clock)
    return result


def execute_report(report, workload=None, *, mode: str = "closed",
                   generator=None, **kwargs) -> ExecutionResult:
    """``execute_plan`` with everything resolved from a
    ``ProvisionReport``: its scenario, allocation, plan, delay/quality
    models and component names.  ``workload`` is a workload name or
    instance (``None`` works with ``executor="simulated"``); remaining
    keywords are ``execute_plan``'s (``device=`` reaches a workload
    built from its name)."""
    from repro_torch.api.provisioner import make_workload
    wl = make_workload(workload, kwargs.pop("device", "cuda"))
    scheduler = kwargs.pop("scheduler", None)
    if scheduler is None:
        name = getattr(report, "scheduler_name", "")
        scheduler = name if name in SCHEDULERS else "stacking"
    allocator = kwargs.pop("allocator", None)
    if allocator is None:
        name = getattr(report, "allocator_name", "")
        allocator = name if name in ALLOCATORS else "inv_se"
    kwargs.setdefault("delay", report.delay)
    kwargs.setdefault("quality", report.quality)
    return execute_plan(report.scenario, report.plan, report.allocation,
                        wl, mode=mode, generator=generator,
                        scheduler=scheduler, allocator=allocator, **kwargs)


def replay_plan(executed_batches, steps_completed,
                delay: DelayModel) -> BatchPlan:
    """A ``BatchPlan`` replaying an online run's committed batch
    sequence (``OnlineResult.executed_batches``): same batches, same
    order, simulated start instants as start times."""
    counters: dict = {}
    batches, starts = [], []
    for t_start, ids in executed_batches:
        batch = []
        for k in ids:
            batch.append((k, counters.get(k, 0)))
            counters[k] = counters.get(k, 0) + 1
        batches.append(batch)
        starts.append(float(t_start))
    if counters != {k: v for k, v in steps_completed.items() if v}:
        # the reference's AssertionError, also under ``python -O``
        raise AssertionError("executed batch log disagrees with final "
                             "step counts")
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=dict(counters), delay=delay)


def replay_result(workload, result, delay: DelayModel, generator=None, *,
                  executor=None,
                  executor_kwargs: Optional[dict] = None) -> WorkloadOutput:
    """Re-run an ``OnlineResult``'s committed batch sequence on a real
    executor, open loop, with per-batch timing."""
    if result.executed_batches is None:
        raise ValueError("this result carries no executed-batch log")
    steps = {o.id: o.steps for o in result.outcomes}
    plan = replay_plan(result.executed_batches, steps, delay)
    session = make_session(workload, plan, generator, executor=executor,
                           executor_kwargs=executor_kwargs)
    timings = []
    for _, ids in result.executed_batches:
        timings.append((len(ids), session.run_batch(ids, timed=True)))
    return WorkloadOutput(content=session.finish(), timings=timings)


def with_kwargs(fn, kwargs: Optional[dict]):
    """Bind component kwargs (allocator seeds etc.) onto a callable."""
    return functools.partial(fn, **kwargs) if kwargs else fn
