"""Batch-denoising executor: runs a BatchPlan against the DDIM U-Net.

The port of ``repro.diffusion.executor``.  Each service k ends the plan
with T_k steps on its evenly-spaced T_k-step DDIM schedule.  Batch n
gathers the current latents of its services (at *different* step
indices of *different* schedules), advances them with ONE batched U-Net
call using per-sample timesteps, and scatters the results back: the
parallelism the paper's Fig. 1a measures.

Two execution engines share the ``DenoiseSession`` interface:

  * ``"dict"`` (default): latents live in a per-service dict and each
    batch is stacked, stepped eagerly and scattered back.
  * ``"bucketed"`` (``diffusion/bucketed.py``): all K latents live in
    one pool, batches run as power-of-two padded gather->step->scatter
    programs, and stable plan phases fuse into multi-step programs.  On
    the card each program is a CUDA graph, captured at first use and
    cached on the executor in ``_programs`` (the reference's AOT
    programs); capture seconds go to ``compile_log``.  On the CPU the
    same functions run eagerly and nothing is captured.

Timed readings are the real step, run once: on the card the host clock
between two ``torch.cuda.synchronize`` calls.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.configs.ddim_cifar10 import UNetConfig
from repro_torch.core.execution import EXEC_ENGINES, exec_engine_default
from repro_torch.core.plan import BatchPlan
from repro_torch.diffusion import ddim, unet


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class BatchDenoisingExecutor:
    def __init__(self, cfg: UNetConfig, params,
                 num_train_timesteps: Optional[int] = None,
                 device="cuda", exec_engine: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.T_train = num_train_timesteps or cfg.num_train_timesteps
        if exec_engine is not None and exec_engine not in EXEC_ENGINES:
            raise ValueError(f"unknown exec_engine {exec_engine!r}; "
                             f"expected one of {EXEC_ENGINES}")
        self.exec_engine = exec_engine
        # captured programs (CUDA graphs of diffusion/bucketed.py),
        # keyed by (kind, pool rows, padded batch[, steps])
        self._programs: Dict[tuple, object] = {}
        # [(program key, capture seconds)] in capture order
        self.compile_log: List[Tuple[tuple, float]] = []
        # capture entries added by the most recent measure_delay_curve
        self.last_compile_log: List[Tuple[tuple, float]] = []
        # what the bucketed graphs share: one static pool per row count
        # (graphs bind addresses), the holder whose rows it holds, one
        # memory pool for every graph's intermediates and one stream
        # for every warm step and capture
        self._pools: Dict[int, torch.Tensor] = {}
        self._pool_owner: Dict[int, object] = {}
        self._graph_mempool = None
        self._side_stream = None
        # (pool rows, padded batch) already run once eagerly on the card
        self._warm: set = set()
        # program executions (all engines, all sessions): a dict step,
        # a graph replay, an eager bucketed step or scan chunk
        self.dispatches = 0
        # U-Net forwards run outside a capture (a graph replay runs
        # its captured forwards without counting here)
        self.forwards = 0

    def eps_fn(self, x, t):
        return unet.forward(self.cfg, self.params, x, t)

    def step_fn(self, x, t_now, t_next):
        """One batched DDIM step with per-sample timesteps: the
        function every engine's programs are built from."""
        if not (x.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.forwards += 1
        return ddim.ddim_step(self.eps_fn, x, t_now, t_next, self.T_train)

    def resolve_engine(self, exec_engine: Optional[str] = None) -> str:
        """Call-site override > constructor knob > process default."""
        eng = exec_engine or self.exec_engine or exec_engine_default()
        if eng not in EXEC_ENGINES:
            raise ValueError(f"unknown exec_engine {eng!r}; "
                             f"expected one of {EXEC_ENGINES}")
        return eng

    def program(self, key: tuple, build):
        """The program cached under ``key``, built by ``build()`` (a
        CUDA graph capture) at first use, its seconds logged in
        ``compile_log`` and, under a profiler, as an ``engine.capture``
        span on the same clock readings."""
        prog = self._programs.get(key)
        if prog is None:
            t0 = time.perf_counter()
            prog = build()
            _sync(self.device)
            t1 = time.perf_counter()
            self.compile_log.append((key, t1 - t0))
            obs.record("engine.capture", t0, t1, key=repr(key))
            self._programs[key] = prog
        return prog

    def graph_counts(self) -> Dict[tuple, Dict[str, int]]:
        """Per captured program: the U-Net forwards one replay runs
        (``steps``), the groupnorm_silu launches captured in it
        (``launches``) and its replays so far: a replay launches its
        kernels without moving the wrappers' counters."""
        return {key: dict(steps=g.steps, launches=g.launches,
                          replays=g.replays)
                for key, g in self._programs.items()}

    def open_session(self, plan: BatchPlan,
                     generator: Optional[torch.Generator] = None,
                     latents: Optional[Mapping[int, object]] = None,
                     exec_engine: Optional[str] = None
                     ) -> "DenoiseSession":
        """Stepwise execution handle: batches are driven one
        ``run_batch`` call at a time, so a closed loop
        (``core/execution.py``) can observe wall-clock and retarget
        remaining schedules between batches."""
        if self.resolve_engine(exec_engine) == "bucketed":
            # imported here: bucketed.py subclasses DenoiseSession
            from repro_torch.diffusion.bucketed import \
                BucketedDenoiseSession
            return BucketedDenoiseSession(self, plan, generator, latents)
        return DenoiseSession(self, plan, generator, latents)

    def run(self, plan: BatchPlan,
            generator: Optional[torch.Generator] = None,
            timed: bool = False,
            latents: Optional[Mapping[int, object]] = None,
            exec_engine: Optional[str] = None
            ) -> Tuple[Dict[int, np.ndarray], List]:
        """Execute the plan.  Returns ({service: final image}, timings).

        timings: list of (batch_size, seconds) when timed=True.
        Zero-step services are never batched; their latent comes back
        untouched.  Untimed runs go through ``run_plan``, so the
        bucketed engine can fuse stable plan phases into multi-step
        programs; timed runs stay stepwise (one reading per batch)."""
        sess = self.open_session(plan, generator, latents, exec_engine)
        batches = [[k for k, _ in batch] for batch in plan.batches]
        timings = []
        if timed:
            for ks in batches:
                timings.append((len(ks), sess.run_batch(ks, timed=True)))
        else:
            sess.run_plan(batches)
        return sess.finish(), timings

    def step_batch(self, latents: Dict[int, torch.Tensor],
                   schedule: Dict[int, Tuple[int, int]],
                   ks: List[int], timed: bool) -> float:
        """Advance ``ks`` one DDIM step in ONE batched U-Net call,
        scattering results back into ``latents``.  Returns measured
        seconds when ``timed`` (0.0 otherwise)."""
        x = torch.stack([latents[k] for k in ks])
        t_now = torch.tensor([schedule[k][0] for k in ks], dtype=torch.int64,
                             device=self.device)
        t_next = torch.tensor([schedule[k][1] for k in ks],
                              dtype=torch.int64, device=self.device)
        dt = 0.0
        if timed:
            _sync(self.device)
            t0 = time.perf_counter()
            x = self.step_fn(x, t_now, t_next)
            _sync(self.device)
            dt = time.perf_counter() - t0
        else:
            x = self.step_fn(x, t_now, t_next)
        self.dispatches += 1
        for i, k in enumerate(ks):
            latents[k] = x[i]
        return dt

    def measure_delay_curve(self, generator: Optional[torch.Generator] = None,
                            batch_sizes=range(1, 17), reps: int = 3,
                            exec_engine: Optional[str] = None
                            ) -> List[Tuple[int, float]]:
        """Fig. 1a measurement: steady-state per-step delay vs batch
        size, the best of ``reps`` readings after one warm call.  On the
        bucketed engine sizes share power-of-two bucket programs, and
        the reading for size X is the padded bucket's cost, what that
        engine pays; capture seconds land in ``last_compile_log``."""
        if generator is None:
            generator = torch.Generator().manual_seed(1)
        clog0 = len(self.compile_log)
        if self.resolve_engine(exec_engine) == "bucketed":
            from repro_torch.diffusion.bucketed import \
                measure_bucketed_curve
            out = measure_bucketed_curve(self, generator, batch_sizes, reps)
        else:
            out = self._measure_dict_curve(generator, batch_sizes, reps)
        self.last_compile_log = self.compile_log[clog0:]
        return out

    def _measure_dict_curve(self, generator, batch_sizes, reps):
        cfg = self.cfg
        out = []
        for X in batch_sizes:
            x = torch.randn((X, cfg.image_size, cfg.image_size,
                             cfg.in_channels), generator=generator,
                            device=generator.device).to(self.device)
            t = torch.full((X,), self.T_train // 2, dtype=torch.int64,
                           device=self.device)
            tn = t - 1
            self.step_fn(x, t, tn)               # warm call
            best = float("inf")
            for _ in range(reps):
                _sync(self.device)
                t0 = time.perf_counter()
                self.step_fn(x, t, tn)
                _sync(self.device)
                best = min(best, time.perf_counter() - t0)
            out.append((int(X), best))
        return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


class DenoiseSession:
    """One plan execution, one batch at a time.

    Initial latents come from ``latents`` (a mapping from service id to
    an (H, W, C) array, e.g. the reference session's) or are drawn from
    ``generator`` in sorted-id order (a CPU generator seeded 0 when
    neither is given).  Each service carries its *remaining* DDIM
    timesteps; ``retarget`` swaps them for a fresh chain when a replan
    changes a service's total step count.  Services retired at zero
    steps keep their noise latent untouched and are never batched.
    """

    def __init__(self, executor: BatchDenoisingExecutor, plan: BatchPlan,
                 generator: Optional[torch.Generator] = None,
                 latents: Optional[Mapping[int, object]] = None):
        self.executor = executor
        cfg = executor.cfg
        dev = executor.device
        shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
        ids = sorted(plan.steps_completed)
        if latents is not None:
            missing = set(ids) - set(latents)
            if missing:
                raise KeyError(f"latents missing services {sorted(missing)}")
            self.latents = {
                k: torch.tensor(np.asarray(latents[k], np.float32),
                                device=dev).reshape(shape)
                for k in ids}
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            noise = torch.randn((len(ids),) + shape, generator=generator,
                                device=generator.device).to(dev)
            self.latents = {k: noise[i] for i, k in enumerate(ids)}
        self.steps_done: Dict[int, int] = {k: 0 for k in ids}
        # remaining timesteps, next-to-run first; [] = done denoising
        self._remaining: Dict[int, List[int]] = {
            k: list(ddim.ddim_timesteps(T, executor.T_train)) if T > 0
            else []
            for k, T in plan.steps_completed.items()}
        # telemetry: dispatches per exact batch size
        self._dispatch: Dict[int, int] = {}

    def run_batch(self, ks: List[int], timed: bool = False) -> float:
        """Advance each service in ``ks`` by one step of its remaining
        schedule, in one batched U-Net call.  Returns the measured
        wall-clock seconds when ``timed`` (0.0 otherwise)."""
        schedule = {}
        for k in ks:
            rem = self._remaining[k]
            if not rem:
                raise ValueError(
                    f"service {k} has no remaining denoising steps")
            schedule[k] = (int(rem[0]), int(rem[1]) if len(rem) > 1 else -1)
        dt = self.executor.step_batch(self.latents, schedule, list(ks),
                                      timed)
        self._dispatch[len(ks)] = self._dispatch.get(len(ks), 0) + 1
        for k in ks:
            self._remaining[k].pop(0)
            self.steps_done[k] += 1
        return dt

    def run_plan(self, batches: List[List[int]]) -> None:
        """Execute a whole list of batches untimed."""
        for ks in batches:
            self.run_batch(ks)

    def retarget(self, totals: Dict[int, int]) -> None:
        """Re-aim services at new TOTAL step counts (executed steps
        included).  A total equal to ``steps_done`` retires the service
        where it stands; a total below it, or new steps for a fully
        denoised chain, is a resurrection and raises."""
        for k, total in totals.items():
            done = self.steps_done[k]
            extra = int(total) - done
            if extra < 0:
                raise ValueError(
                    f"service {k}: retarget total {total} < "
                    f"{done} steps already executed")
            if extra == 0:
                self._remaining[k] = []
            elif done == 0:
                self._remaining[k] = list(
                    ddim.ddim_timesteps(extra, self.executor.T_train))
            elif not self._remaining[k]:
                raise ValueError(
                    f"service {k} already fully denoised; cannot "
                    f"schedule {extra} more steps")
            else:
                self._remaining[k] = list(ddim.retarget_timesteps(
                    self._remaining[k][0], extra))

    def telemetry(self) -> dict:
        """Engine and dispatch counters for this session (the
        reference's keys; no compiles in eager PyTorch)."""
        return {
            "exec_engine": "dict",
            "dispatches": int(sum(self._dispatch.values())),
            "by_size": {str(b): int(n)
                        for b, n in sorted(self._dispatch.items())},
            "compiles": 0,
            "compile_s": 0.0,
        }

    def finish(self) -> Dict[int, np.ndarray]:
        """Final images (zero-step services: their untouched latent)."""
        return {k: v.cpu().numpy() for k, v in self.latents.items()}
