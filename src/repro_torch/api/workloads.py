"""The diffusion workload: the DDIM ``BatchDenoisingExecutor`` behind the
calls a ``Provisioner`` makes (calibrate, execute, open a session).

The port of ``repro.api.workloads.DiffusionWorkload``.  Randomness is a
``torch.Generator`` instead of a jax key; ``execute`` and
``open_session`` also take ``latents=`` (service id -> (H, W, C) array)
so a run can start from given noise.  The model is built lazily, at the
first call that needs it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.ddim_cifar10 import SMOKE
from repro_torch.core.delay_model import DelayModel, fit
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.diffusion import unet
from repro_torch.diffusion.executor import BatchDenoisingExecutor
from repro_torch.models.params import init_params


@dataclasses.dataclass
class WorkloadOutput:
    """What executing a plan produced: per-service content and, when
    timed, per-batch ``(batch_size, seconds)`` readings."""
    content: Dict[int, Any]
    timings: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)


class DiffusionWorkload:
    """Batch denoising on the DDIM U-Net (the paper's workload).

    cfg: a ``UNetConfig`` (default ``SMOKE``); params: the U-Net's param
    tree on any device (default: ``init_params`` from a CPU generator
    seeded ``init_seed``); device: where the U-Net runs."""

    name = "diffusion"

    def __init__(self, cfg=None, params=None, executor=None,
                 init_seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.params = params
        self._executor = executor
        self.init_seed = init_seed
        self.device = resolve_device(device) if executor is None \
            else executor.device

    def _ex(self):
        if self._executor is None:
            cfg = self.cfg if self.cfg is not None else SMOKE
            params = self.params
            if params is None:
                params = init_params(
                    unet.schema(cfg),
                    torch.Generator().manual_seed(self.init_seed),
                    self.device)
            self._executor = BatchDenoisingExecutor(cfg, params,
                                                    device=self.device)
            self.cfg, self.params = cfg, self._executor.params
        return self._executor

    def default_delay(self) -> DelayModel:
        return DelayModel()                    # paper's RTX-3050 constants

    def default_quality(self) -> QualityModel:
        return PowerLawFID()

    def measure_delay_curve(self, generator: Optional[torch.Generator] = None,
                            batch_sizes: Sequence[int] = (1, 2, 4, 8),
                            reps: int = 3):
        """Fig. 1a raw data: steady-state per-step delay vs batch size."""
        return self._ex().measure_delay_curve(generator,
                                              batch_sizes=batch_sizes,
                                              reps=reps)

    def calibrate(self, generator: Optional[torch.Generator] = None, *,
                  batch_sizes: Sequence[int] = (1, 2, 4, 8),
                  reps: int = 3) -> DelayModel:
        curve = self.measure_delay_curve(generator, batch_sizes, reps)
        return fit([c[0] for c in curve], [c[1] for c in curve])

    def execute(self, plan: BatchPlan,
                generator: Optional[torch.Generator] = None, *,
                timed: bool = False,
                latents: Optional[Mapping[int, Any]] = None
                ) -> WorkloadOutput:
        images, timings = self._ex().run(plan, generator, timed=timed,
                                         latents=latents)
        return WorkloadOutput(content=images, timings=timings)

    def open_session(self, plan: BatchPlan,
                     generator: Optional[torch.Generator] = None,
                     latents: Optional[Mapping[int, Any]] = None):
        """Stepwise execution handle (``DenoiseSession``)."""
        return self._ex().open_session(plan, generator, latents)
