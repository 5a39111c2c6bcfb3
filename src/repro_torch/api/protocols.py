"""The provisioner API's three protocols.

The paper's pipeline is a three-stage composition

    Allocator (P1)  ->  Scheduler (P2)  ->  Workload (execution)

and these protocols pin down the one calling convention per stage that
every implementation -- paper method, baseline, or beyond-paper variant
-- must share.  Anything satisfying them can be dropped into a
``Provisioner`` (and registered by name, see
``repro_torch.api.registry``).  The port of ``repro.api.protocols``:
randomness is a ``torch.Generator`` (or an allocator's ``seed=``) where
the reference takes a jax PRNG key.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Dict, List, Optional, Protocol, Sequence, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import Scenario, ServiceRequest


@runtime_checkable
class Scheduler(Protocol):
    """P2 solver: generation budgets -> batch-denoising plan."""

    def __call__(self, services: Sequence[ServiceRequest],
                 tau_prime: Dict[int, float], delay: DelayModel,
                 quality: QualityModel) -> BatchPlan: ...


@runtime_checkable
class OffsetScheduler(Scheduler, Protocol):
    """Optional P2 extension: a scheduler that reasons natively about
    per-service progress.

    ``plan`` receives ``offsets`` -- denoising steps each service has
    already executed, positional, aligned with ``services`` -- and must
    return a plan of *additional* steps whose quality is judged as
    ``fid(offset + new)``.  The online replanner
    (``repro_torch.core.online``) dispatches to ``plan`` whenever
    progress exists; calling the instance itself is the plain
    ``Scheduler`` path (zero offsets).  ``supports_offsets`` must be
    ``True``: it is the dispatch marker the replanner probes for."""

    supports_offsets: bool

    def plan(self, services: Sequence[ServiceRequest],
             tau_prime: Dict[int, float], delay: DelayModel,
             quality: QualityModel,
             offsets: Sequence[int]) -> BatchPlan: ...


@runtime_checkable
class Allocator(Protocol):
    """P1 solver: scenario (+ inner scheduler for fitness) -> bandwidth
    allocation, one entry per service, summing to the scenario budget;
    a search allocator takes ``seed=`` among its ``kwargs``."""

    def __call__(self, scenario: Scenario, scheduler: Scheduler,
                 delay: DelayModel, quality: QualityModel,
                 **kwargs) -> np.ndarray: ...


@dataclasses.dataclass
class WorkloadOutput:
    """What executing a plan produced: per-service content and, when
    timed, per-batch ``(batch_size, seconds)`` readings (the raw
    material for refitting the affine DelayModel g(X) = aX + b)."""
    content: Dict[int, Any]
    timings: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)


@runtime_checkable
class Workload(Protocol):
    """A generative step executor: owns the model that turns a BatchPlan
    into content, plus the hardware-calibration hooks (Fig. 1a) and the
    quality model (Fig. 1b) that parameterize the optimization for it.
    ``generator`` draws its noise (None: the workload's default)."""

    name: str

    def default_delay(self) -> DelayModel: ...

    def default_quality(self) -> QualityModel: ...

    def calibrate(self, generator: Optional[torch.Generator] = None, *,
                  batch_sizes: Sequence[int] = (1, 2, 4, 8),
                  reps: int = 2) -> DelayModel: ...

    def execute(self, plan: BatchPlan,
                generator: Optional[torch.Generator] = None, *,
                timed: bool = False) -> WorkloadOutput: ...
