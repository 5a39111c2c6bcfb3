"""The workloads behind the calls a ``Provisioner`` makes (calibrate,
execute, open a session): ``DiffusionWorkload`` wraps the DDIM
``BatchDenoisingExecutor`` (the paper's image generation) and
``DecodeWorkload`` the LLM ``ServingEngine`` (one denoising task == one
decode token).

The port of ``repro.api.workloads``.  Randomness is a
``torch.Generator`` instead of a jax key; the diffusion workload's
``execute`` and ``open_session`` also take ``latents=`` (service id ->
(H, W, C) array) so a run can start from given noise.  ``exec_engine``
picks the denoising engine (``"dict"`` or ``"bucketed"``,
``diffusion/bucketed.py``).  Models are built lazily, at the first call
that needs them.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.api.protocols import WorkloadOutput
from repro_torch.api.registry import register_workload
from repro_torch.config import RunConfig, get_config, smoke_variant
from repro_torch.configs.ddim_cifar10 import SMOKE
from repro_torch.core.delay_model import DelayModel, fit
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import PowerLawFID, QualityModel
from repro_torch.diffusion import unet
from repro_torch.diffusion.executor import BatchDenoisingExecutor
from repro_torch.models import api as models_api
from repro_torch.models.params import init_params
from repro_torch.serving.engine import Request, ServingEngine, TokenQuality


@register_workload("diffusion")
class DiffusionWorkload:
    """Batch denoising on the DDIM U-Net (the paper's workload).

    cfg: a ``UNetConfig`` (default ``SMOKE``); params: the U-Net's param
    tree on any device (default: ``init_params`` from a CPU generator
    seeded ``init_seed``); device: where the U-Net runs; exec_engine:
    the engine of every session this workload opens (``"dict"`` /
    ``"bucketed"``; None = the executor's, then the process default)."""

    name = "diffusion"

    def __init__(self, cfg=None, params=None, executor=None,
                 init_seed: int = 0, device="cuda",
                 exec_engine: Optional[str] = None):
        self.cfg = cfg
        self.params = params
        self._executor = executor
        self.init_seed = init_seed
        self.exec_engine = exec_engine
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
            self._executor = BatchDenoisingExecutor(
                cfg, params, device=self.device,
                exec_engine=self.exec_engine)
            self.cfg, self.params = cfg, self._executor.params
        return self._executor

    def default_delay(self) -> DelayModel:
        return DelayModel()                    # paper's RTX-3050 constants

    def default_quality(self) -> QualityModel:
        return PowerLawFID()

    def measure_delay_curve(self, generator: Optional[torch.Generator] = None,
                            batch_sizes: Sequence[int] = (1, 2, 4, 8),
                            reps: int = 3,
                            exec_engine: Optional[str] = None):
        """Fig. 1a raw data: steady-state per-step delay vs batch size.
        Capture time never lands in the readings; the executor's
        ``last_compile_log`` carries it separately."""
        return self._ex().measure_delay_curve(generator,
                                              batch_sizes=batch_sizes,
                                              reps=reps,
                                              exec_engine=exec_engine)

    def calibrate(self, generator: Optional[torch.Generator] = None, *,
                  batch_sizes: Sequence[int] = (1, 2, 4, 8),
                  reps: int = 3,
                  exec_engine: Optional[str] = None) -> DelayModel:
        curve = self.measure_delay_curve(generator, batch_sizes, reps,
                                         exec_engine=exec_engine)
        return fit([c[0] for c in curve], [c[1] for c in curve])

    def execute(self, plan: BatchPlan,
                generator: Optional[torch.Generator] = None, *,
                timed: bool = False,
                latents: Optional[Mapping[int, Any]] = None,
                exec_engine: Optional[str] = None) -> WorkloadOutput:
        images, timings = self._ex().run(plan, generator, timed=timed,
                                         latents=latents,
                                         exec_engine=exec_engine)
        return WorkloadOutput(content=images, timings=timings)

    def open_session(self, plan: BatchPlan,
                     generator: Optional[torch.Generator] = None,
                     latents: Optional[Mapping[int, Any]] = None,
                     exec_engine: Optional[str] = None):
        """Stepwise execution handle (the ``"diffusion"`` entry of
        ``EXECUTORS``): the closed loop drives batches itself.
        ``exec_engine`` overrides the workload's engine for this
        session."""
        return self._ex().open_session(plan, generator, latents,
                                       exec_engine=exec_engine)


@register_workload("llm_decode")
class DecodeWorkload:
    """Deadline-aware autoregressive decoding on the ``ServingEngine``.

    cfg: a ``ModelConfig`` (default: the smoke variant of ``arch``);
    params: its param tree on any device (default: ``init_model`` from a
    CPU generator seeded ``init_seed``); run: a ``RunConfig`` (default:
    bfloat16 KV cache); device: where the model runs.  Prompts are
    ``prompt_len`` tokens drawn as the reference draws them, so both
    packages serve identical prompts."""

    name = "llm_decode"

    def __init__(self, cfg=None, params=None, run=None,
                 max_len: int = 128, prompt_len: int = 8,
                 arch: str = "tinyllama-1.1b", engine=None,
                 init_seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.run = run
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.arch = arch
        self._engine = engine
        self.init_seed = init_seed
        self.device = resolve_device(device) if engine is None \
            else engine.device

    def _eng(self) -> ServingEngine:
        if self._engine is None:
            cfg = self.cfg if self.cfg is not None \
                else smoke_variant(get_config(self.arch))
            if cfg.family in ("audio", "vlm"):
                # the reference builds this engine without the modality
                # extras these families read, and cannot serve them here
                raise NotImplementedError(
                    f"DecodeWorkload: the {cfg.family} family ({cfg.name}) "
                    f"needs modality extras, which DecodeWorkload does not "
                    f"give its engine (nor does the reference's); serve it "
                    f"through serving.engine.ServingEngine(extras=...)")
            params = self.params
            if params is None:
                params = models_api.init_model(
                    cfg, torch.Generator().manual_seed(self.init_seed),
                    self.device)
            run = self.run if self.run is not None else RunConfig()
            self._engine = ServingEngine(cfg, params, run, self.max_len,
                                         delay=self.default_delay(),
                                         device=self.device)
            self.cfg, self.params, self.run = cfg, self._engine.params, run
        return self._engine

    def default_delay(self) -> DelayModel:
        # the reference's CPU-scale guesses, not a card measurement;
        # calibrate() measures the real g(X)
        return DelayModel(a=0.002, b=0.02)

    def default_quality(self) -> QualityModel:
        return TokenQuality()

    def measure_delay_curve(self,
                            generator: Optional[torch.Generator] = None,
                            batch_sizes: Sequence[int] = (1, 2, 4),
                            reps: int = 2):
        """Fig. 1a raw data for decode steps: [(X, best seconds)]
        (``generator`` is unused: the prompts are zeros, as in the
        reference's calibration)."""
        return self._eng().measure_decode_curve(batch_sizes, reps)

    def calibrate(self, generator: Optional[torch.Generator] = None, *,
                  batch_sizes: Sequence[int] = (1, 2, 4),
                  reps: int = 2) -> DelayModel:
        """Fit g(X) from timed decode steps."""
        return self._eng().measure_decode_delay(batch_sizes=batch_sizes,
                                                reps=reps)

    def _prompt(self, service_id: int, vocab: int) -> np.ndarray:
        rng = np.random.default_rng(self.init_seed * 7919 + service_id)
        return rng.integers(0, vocab, self.prompt_len).astype(np.int32)

    def _load_requests(self, plan: BatchPlan) -> None:
        eng = self._eng()
        top = max(plan.steps_completed.values(), default=0)
        if self.prompt_len + top > self.max_len:
            raise ValueError(
                f"plan wants {top} tokens but max_len={self.max_len} "
                f"leaves room for {self.max_len - self.prompt_len}; "
                f"raise max_len or tighten deadlines")
        eng.requests.clear()
        for k in sorted(plan.steps_completed):
            eng.requests[k] = Request(
                id=k, prompt=self._prompt(k, eng.cfg.vocab_size),
                deadline=float("inf"))

    def execute(self, plan: BatchPlan,
                generator: Optional[torch.Generator] = None, *,
                timed: bool = False,
                latents: Optional[Mapping[int, Any]] = None
                ) -> WorkloadOutput:
        """Greedy tokens per request (``generator`` is unused: decoding
        is argmax).  Decoding starts from prompts, so ``latents`` must be
        None."""
        if latents is not None:
            raise ValueError("llm_decode starts from prompts; it takes no "
                             "latents")
        self._load_requests(plan)
        eng = self._eng()
        out = eng.execute(plan, timed=timed)
        return WorkloadOutput(content={k: list(v) for k, v in out.items()},
                              timings=list(eng.last_timings))

    def open_session(self, plan: BatchPlan,
                     generator: Optional[torch.Generator] = None,
                     exec_engine: Optional[str] = None):
        """Stepwise decode handle (``DecodeSession``, the
        ``"llm_decode"`` entry of ``EXECUTORS``); ``generator`` is
        unused: decoding is greedy argmax."""
        if exec_engine not in (None, "dict"):
            raise ValueError(f"llm_decode executor has no "
                             f"exec_engine={exec_engine!r} (the bucketed "
                             f"engine is diffusion-only)")
        self._load_requests(plan)
        return self._eng().open_session(plan)
