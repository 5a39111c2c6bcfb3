"""Pool-resident bucketed denoising engine (``exec_engine="bucketed"``).

The port of ``repro.diffusion.bucketed``.  The dict engine stacks K
latents from a per-service dict on every step and scatters them back.
This engine keeps all K latents in ONE tensor for the whole session and
drives each batch with a single gather->DDIM-step->scatter program:

  * **Pool layout**: ``(R, H, W, C)`` with ``R = shape_bucket(K + 1)``
    rows; row i holds service ``ids[i]``'s latent, the last row is a
    scratch row for padded lanes, and the rows between are never
    gathered.  Rounding R to a power of two keeps the pool sizes, and
    so the graphs an executor holds, to a few across all K.
  * **Power-of-two buckets**: a batch of B services runs at padded width
    ``shape_bucket(B)`` (min 2).  Padded lanes gather the scratch row
    with ``t_now = -1``; ``ddim_step`` passes such rows through
    unchanged, and the duplicate scatter indices all write that same
    unchanged value, so padding is deterministic and invisible.  Any
    plan over K services needs at most ceil(log2 K) step programs.
  * **Multi-step programs**: ``run_plan`` fuses runs of consecutive
    batches with identical service composition (a stable phase of a
    STACKING plan) into programs of ``_SCAN_CHUNKS`` steps, so a stable
    phase costs one dispatch per chunk, not one per step.  Timed
    execution stays stepwise: the closed loop needs one wall-clock
    reading per batch.

On the card every program is a CUDA graph, the counterpart of the
reference's AOT-compiled program with a donated pool.  A graph binds
addresses, so its inputs are static buffers that the executor owns: one
pool per row count R, shared by that size's graphs, and one int64 lanes
tensor per graph (padded row indices, then the (t_now, t_next) pair of
each step).  A step copies its lanes in and replays.  A session whose
rows are not in the static pool copies them in first and saves the
previous holder's rows out (``_Pool._seat``).  Before its first capture
each (rows, bucket) runs one eager all-padding step on the executor's
side stream, the stream it captures on: that builds and loads the
kernels, moves the DDIM table to the card and lets cuDNN and cuBLAS
pick algorithms and the stream's one workspace outside the capture.
Every graph captures into one memory pool of the executor: their only
outputs are the static pool and nothing captured stays alive, and
replays run one after another on one stream.  There is no
eager path on the card: a capture that fails raises.  On a CPU tensor
the same functions run eagerly, with nothing captured.

Numerical contract: per-row results match the dict engine within
``MATCH_TOL``; the dict engine stays the exact-per-row reference.  On
the card the U-Net runs its matrix products, and the convolutions whose
cuDNN algorithm depends on the batch size, at the bucket width in
either engine (``unet.product_rows``, ``unet.conv_rows``), so a row
sums in the same order at B and at shape_bucket(B).
"""

from __future__ import annotations

import time
import weakref
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.execution import shape_bucket
from repro_torch.diffusion.executor import (BatchDenoisingExecutor,
                                            DenoiseSession, _sync)
from repro_torch.kernels.groupnorm_silu import ops as gn_ops

# bucketed-vs-dict per-row tolerance: a padded-width batch may sum in
# another order than the exact-width one; per-row math is the same
MATCH_TOL = {"atol": 1e-5, "rtol": 1e-5}

# multi-step chunk lengths, largest first: a stable phase of C steps runs
# as greedy chunks (e.g. C=23 -> 16+4+2+1 step), so each bucket captures
# at most len(_SCAN_CHUNKS) multi-step programs
_SCAN_CHUNKS = (32, 16, 8, 4, 2)


def pool_step(step_fn, pool, idx, t_now, t_next) -> None:
    """Gather rows ``idx`` of ``pool``, advance them one DDIM step with
    per-lane timesteps, and scatter them back in place."""
    pool.index_copy_(0, idx, step_fn(pool.index_select(0, idx), t_now,
                                     t_next))


def pool_scan(step_fn, pool, idx, ts) -> None:
    """``pool_step`` over a ``(C, 2, Bp)`` stack of (t_now, t_next)."""
    for t in ts:
        pool_step(step_fn, pool, idx, t[0], t[1])


class _Graph:
    """One captured program: ``steps`` pool steps over the executor's
    static pool, reading the static ``lanes`` tensor (row 0 the padded
    row indices, rows 1 + 2c and 2 + 2c step c's t_now and t_next).
    ``launches``: groupnorm_silu launches captured (the wrapper's
    counter moved by them during the capture); ``replays``: calls."""

    def __init__(self, ex: BatchDenoisingExecutor, pool: torch.Tensor,
                 Bp: int, steps: int):
        rows = pool.shape[0]
        self.steps, self.replays = steps, 0
        self.lanes = torch.full((1 + 2 * steps, Bp), -1, dtype=torch.int64,
                                device=pool.device)
        self.lanes[0] = rows - 1                  # every lane on scratch
        self._host = torch.empty(self.lanes.shape, dtype=torch.int64,
                                 pin_memory=True)
        self._copied = torch.cuda.Event()
        if ex._side_stream is None:
            # one stream for every warm step and capture: cuBLAS keeps a
            # workspace per stream for as long as the process runs
            ex._side_stream = torch.cuda.Stream(pool.device)
            ex._graph_mempool = torch.cuda.graph_pool_handle()
        side = ex._side_stream
        if (rows, Bp) not in ex._warm:
            # one all-padding step (a pass-through of the scratch row),
            # eager, on the side stream: nothing is built, loaded or
            # chosen for the first time inside the capture
            side.wait_stream(torch.cuda.current_stream(pool.device))
            with torch.cuda.stream(side):
                pool_step(ex.step_fn, pool, self.lanes[0], self.lanes[1],
                          self.lanes[2])
            torch.cuda.current_stream(pool.device).wait_stream(side)
            ex._warm.add((rows, Bp))
        self.graph = torch.cuda.CUDAGraph()
        before = gn_ops.launches
        with torch.cuda.graph(self.graph, pool=ex._graph_mempool,
                              stream=side):
            pool_scan(ex.step_fn, pool, self.lanes[0],
                      self.lanes[1:].view(steps, 2, Bp))
        self.launches = gn_ops.launches - before

    def __call__(self, lanes: np.ndarray) -> None:
        # the pinned buffer is reused: wait until the last copy out of it
        # has run before writing it again
        self._copied.synchronize()
        self._host.numpy()[...] = lanes
        self.lanes.copy_(self._host, non_blocking=True)
        self._copied.record()
        self.graph.replay()
        self.replays += 1


class _Pool:
    """A latent pool and the programs that step it: plain functions on
    the CPU, the executor's CUDA graphs on the card."""

    def __init__(self, ex: BatchDenoisingExecutor, tensor: torch.Tensor):
        self.ex = ex
        self.tensor = tensor
        self.rows = tensor.shape[0]

    def _seat(self) -> torch.Tensor:
        """Make the executor's static pool of this size hold these rows:
        the previous holder's rows are saved out to a tensor of its own,
        these copied in, and this pool's tensor becomes the static one."""
        ex = self.ex
        static = ex._pools.get(self.rows)
        if static is None:
            static = ex._pools[self.rows] = torch.zeros_like(self.tensor)
        ref = ex._pool_owner.get(self.rows)
        prev = ref() if ref is not None else None
        if prev is not self:
            if prev is not None:
                prev.tensor = static.clone()
            static.copy_(self.tensor)
            self.tensor = static
            ex._pool_owner[self.rows] = weakref.ref(self)
        return static

    def run(self, idx: np.ndarray, ts: np.ndarray,
            timed: bool = False) -> float:
        """Run ``C = len(ts)`` steps over rows ``idx`` with the
        ``(C, 2, Bp)`` timesteps ``ts`` as one program: key ("bstep",
        rows, Bp) for one step, ("bscan", rows, Bp, C) for more.
        Returns measured seconds when ``timed`` (0.0 otherwise)."""
        ex = self.ex
        C, _, Bp = ts.shape
        if self.tensor.is_cuda:
            static = self._seat()
            key = ("bstep", self.rows, Bp) if C == 1 else \
                ("bscan", self.rows, Bp, C)
            prog = ex.program(key, lambda: _Graph(ex, static, Bp, C))
            lanes = np.concatenate([idx[None], ts.reshape(2 * C, Bp)])
            run = lambda: prog(lanes)               # noqa: E731
        else:
            i, t = torch.from_numpy(idx), torch.from_numpy(ts)
            run = lambda: pool_scan(ex.step_fn, self.tensor, i, t)  # noqa: E731
        dt = 0.0
        if timed:
            _sync(self.tensor.device)
            t0 = time.perf_counter()
            run()
            _sync(self.tensor.device)
            dt = time.perf_counter() - t0
        else:
            run()
        ex.dispatches += 1
        return dt


class BucketedDenoiseSession(DenoiseSession):
    """``DenoiseSession`` with pool execution.  Same interface and
    scheduling semantics (``retarget`` is inherited untouched); only the
    step dispatch differs."""

    def __init__(self, executor: BatchDenoisingExecutor, plan,
                 generator=None, latents=None):
        super().__init__(executor, plan, generator, latents)
        ids = sorted(self.steps_done)
        self._ids = ids
        self._row = {k: i for i, k in enumerate(ids)}
        rows = shape_bucket(len(ids) + 1)
        self._scratch = rows - 1
        cfg = executor.cfg
        shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
        self._pool = _Pool(executor, torch.stack(
            [self.latents[k] for k in ids]
            + [torch.zeros(shape, device=executor.device)]
            * (rows - len(ids))))
        # the pool is now the single source of truth; fail loudly if
        # anything still pokes the dict
        self.latents = None
        self._scan_dispatch: Dict[tuple, int] = {}
        self._scan_steps = 0
        # this session's captures are the log entries after this mark
        self._clog0 = len(executor.compile_log)

    def _lanes(self, ks: List[int]):
        """Padded (idx, t_now, t_next) lane arrays for one batch;
        validates remaining schedules like the dict path."""
        Bp = shape_bucket(len(ks))
        idx = np.full((Bp,), self._scratch, np.int64)
        t_now = np.full((Bp,), -1, np.int64)
        t_next = np.full((Bp,), -1, np.int64)
        for lane, k in enumerate(ks):
            rem = self._remaining[k]
            if not rem:
                raise ValueError(
                    f"service {k} has no remaining denoising steps")
            idx[lane] = self._row[k]
            t_now[lane] = rem[0]
            t_next[lane] = rem[1] if len(rem) > 1 else -1
        return idx, t_now, t_next

    def run_batch(self, ks: List[int], timed: bool = False) -> float:
        idx, t_now, t_next = self._lanes(ks)
        Bp = len(idx)
        dt = self._pool.run(idx, np.stack([t_now, t_next])[None], timed)
        self._dispatch[Bp] = self._dispatch.get(Bp, 0) + 1
        for k in ks:
            self._remaining[k].pop(0)
            self.steps_done[k] += 1
        return dt

    def run_plan(self, batches: List[List[int]]) -> None:
        """Fuse runs of consecutive identical-composition batches into
        multi-step programs; mixed phases fall back to single steps."""
        i, n = 0, len(batches)
        while i < n:
            ks = list(batches[i])
            sig = tuple(sorted(ks))
            j = i + 1
            while j < n and tuple(sorted(batches[j])) == sig:
                j += 1
            run = j - i
            if run >= 2 and ks:
                # never scan past a service's remaining schedule: the
                # shortfall surfaces as the same per-batch error the
                # stepwise path would raise
                run = min([run] + [len(self._remaining[k])
                                   for k in ks])
            if run >= 2:
                self._run_scan(ks, run)
                i += run
            else:
                self.run_batch(ks)
                i += 1

    def _run_scan(self, ks: List[int], C: int) -> None:
        Bp = shape_bucket(len(ks))
        idx = np.full((Bp,), self._scratch, np.int64)
        ts = np.full((C, 2, Bp), -1, np.int64)
        for lane, k in enumerate(ks):
            idx[lane] = self._row[k]
            rem = self._remaining[k]
            for c in range(C):
                ts[c, 0, lane] = rem[c]
                ts[c, 1, lane] = rem[c + 1] if c + 1 < len(rem) else -1
        off = 0
        for chunk in _SCAN_CHUNKS:
            while C - off >= chunk:
                self._pool.run(idx, ts[off:off + chunk])
                key = (Bp, chunk)
                self._scan_dispatch[key] = \
                    self._scan_dispatch.get(key, 0) + 1
                self._scan_steps += chunk
                off += chunk
        for k in ks:
            del self._remaining[k][:off]
            self.steps_done[k] += off
        while off < C:     # _SCAN_CHUNKS ends at 2, so at most 1 step
            self.run_batch(ks)
            off += 1

    def telemetry(self) -> dict:
        """The reference's keys; ``compiles``/``compile_s`` count this
        session's graph captures and their seconds (none on the CPU)."""
        mine = self.executor.compile_log[self._clog0:]
        compile_by_bucket: Dict[int, float] = {}
        for key, s in mine:
            if key[0] in ("bstep", "bscan"):
                b = int(key[2])
                compile_by_bucket[b] = compile_by_bucket.get(b, 0.0) + s
        return {
            "exec_engine": "bucketed",
            "dispatches": int(sum(self._dispatch.values())
                              + sum(self._scan_dispatch.values())),
            "by_bucket": {str(b): int(n)
                          for b, n in sorted(self._dispatch.items())},
            "scan_dispatches": {
                f"b{b}_c{c}": int(n)
                for (b, c), n in sorted(self._scan_dispatch.items())},
            "scan_fused_steps": int(self._scan_steps),
            "compiles": len(mine),
            "compile_s": float(sum(s for _, s in mine)),
            "compile_s_by_bucket": {
                str(b): float(s)
                for b, s in sorted(compile_by_bucket.items())},
        }

    def finish(self) -> Dict[int, np.ndarray]:
        """Final images (zero-step services: their untouched latent)."""
        pool = self._pool.tensor.cpu().numpy()
        return {k: pool[self._row[k]] for k in self._ids}


def measure_bucketed_curve(executor: BatchDenoisingExecutor,
                           generator: torch.Generator, batch_sizes,
                           reps: int):
    """Fig. 1a sweep through the bucket programs: sizes sharing a bucket
    share one program, so sweeping 1..16 captures 4 graphs, not 16.
    The reading for size X is the padded bucket's cost: exactly what the
    bucketed engine pays for a size-X batch."""
    cfg = executor.cfg
    sizes = [int(X) for X in batch_sizes]
    pool_rows = shape_bucket(max(shape_bucket(X) for X in sizes) + 1)
    pool = _Pool(executor, torch.randn(
        (pool_rows, cfg.image_size, cfg.image_size, cfg.in_channels),
        generator=generator, device=generator.device).to(executor.device))
    t_mid = executor.T_train // 2
    out = []
    for X in sizes:
        Bp = shape_bucket(X)
        idx = np.full((Bp,), pool_rows - 1, np.int64)
        idx[:X] = np.arange(X)
        ts = np.full((1, 2, Bp), -1, np.int64)
        ts[0, 0, :X] = t_mid
        ts[0, 1, :X] = t_mid - 1
        pool.run(idx, ts)                       # warm dispatch
        best = min(pool.run(idx, ts, timed=True) for _ in range(reps))
        out.append((X, best))
    return out
