"""Deadline-aware LLM serving engine driven by STACKING, in PyTorch.

The port of ``repro.serving.engine``.  The paper's abstraction, an
iterative generation whose per-step cost is affine in batch size and
whose quality rises with step count, maps onto autoregressive decoding:
one denoising task becomes one decode token.  The engine

  1. measures or accepts a DelayModel for decode steps,
  2. plans token generation for all queued requests with a scheduler
     (STACKING by default) under per-request deadlines,
  3. executes the plan batch by batch: gathers the packed requests'
     states, runs ONE batched decode_step, scatters back, and appends
     each request's greedy (argmax) token.

Per-request KV caches are kept unbatched (B=1 views) and stacked on
demand, as in the reference.  Its semantics are kept exactly, quirks
included: equal-length prompts share one prefill call, and a request's
first decode step re-feeds the last prompt token at position S (the
prefill wrote positions 0..S-1).

The engine keeps one set of modality extras (whisper's audio frames,
the VLM's vision embeddings), as the reference does.  Where the
reference prefills X rows against batch-1 extras and fails, the port
expands each batch-1 extras tensor to the rows of the call (a view, no
copy), so a row of a batch-X prefill is the batch-1 prefill of its
prompt.  Decode steps pass the extras through as they are: the models
read the memory from their cross caches there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs, resolve_device
from repro_torch.config import ModelConfig, RunConfig
from repro_torch.core.delay_model import DelayModel, fit
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import ServiceRequest
from repro_torch.models import api


@dataclasses.dataclass(frozen=True)
class TokenQuality:
    """Monotone diminishing-returns 'FID-like' penalty for LLM serving:
    fewer generated tokens = worse response.  Same interface as
    PowerLawFID so STACKING is reused unmodified."""
    target_tokens: int = 64
    penalty_at_zero: float = 100.0

    def fid(self, steps: int) -> float:
        if steps <= 0:
            return self.penalty_at_zero
        return self.penalty_at_zero / (1.0 + steps)

    def mean_fid(self, step_counts) -> float:
        return float(np.mean([self.fid(t) for t in step_counts]))


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray            # (S,) int32
    deadline: float               # seconds from submission
    generated: List[int] = dataclasses.field(default_factory=list)
    cache: Optional[dict] = None


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _slice_at(ndim: int, ax: int, i: int):
    idx = [slice(None)] * ndim
    idx[ax] = slice(i, i + 1)
    return tuple(idx)


def _to_device(tree, device):
    return _tree_map(lambda t: t.to(device), tree)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """params: the model's param tree (moved to ``device``, where the
    model runs).  ``prefill_calls`` and ``decode_calls`` count the model
    calls made, so a run can check its kernel launches against them."""

    def __init__(self, cfg: ModelConfig, params, run: RunConfig,
                 max_len: int, delay: Optional[DelayModel] = None,
                 quality: Optional[QualityModel] = None,
                 extras=None, scheduler="stacking", device="cuda"):
        # lazy import: repro_torch.api (which registers the schedulers)
        # -> api.workloads -> serving
        from repro_torch.api.registry import SCHEDULERS
        self.cfg, self.run = cfg, run
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.max_len = max_len
        self.delay = delay or DelayModel(a=0.002, b=0.02)
        self.quality = quality or TokenQuality()
        self.scheduler = SCHEDULERS.resolve(scheduler)
        self.extras = None if extras is None \
            else _to_device(extras, self.device)
        self.requests: Dict[int, Request] = {}
        self.last_timings: List[tuple] = []
        self.prefill_calls = 0
        self.decode_calls = 0
        self._next_id = 0
        self._prefill = api.make_prefill_step(cfg, run, max_len)
        self._decode = api.make_decode_step(cfg, run)
        # batch axis per cache leaf, derived structurally: the axis whose
        # size changes between a batch=1 and a batch=2 cache (shapes only)
        mod = api.get_model(cfg)
        c1 = mod.init_cache(cfg, 1, max_len, run, device="meta")
        c2 = mod.init_cache(cfg, 2, max_len, run, device="meta")
        self._batch_axes = _tree_map(
            lambda a, b: next(i for i, (x, y) in
                              enumerate(zip(a.shape, b.shape)) if x != y),
            c1, c2)

    # ------------------------------------------------------------------
    def submit(self, prompt: np.ndarray, deadline: float) -> int:
        rid = self._next_id
        self._next_id += 1
        self.requests[rid] = Request(id=rid, prompt=np.asarray(prompt),
                                     deadline=deadline)
        return rid

    def _tokens(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

    def _extras_at(self, rows: int):
        """The extras with each batch-1 tensor expanded to ``rows``."""
        if self.extras is None:
            return None
        return {k: v.expand((rows,) + v.shape[1:])
                if v.shape[0] == 1 else v for k, v in self.extras.items()}

    def prefill(self, tokens: np.ndarray):
        self.prefill_calls += 1
        toks = self._tokens(tokens)
        return self._prefill(self.params, toks, self._extras_at(len(toks)))

    def decode(self, tokens: torch.Tensor, cache):
        self.decode_calls += 1
        return self._decode(self.params, tokens, cache, self.extras)

    def measure_decode_curve(self, batch_sizes=(1, 2, 4, 8),
                             reps: int = 2):
        """Fig.-1a raw data for decode steps on this device: per batch
        size X, a prefill of an all-zero prompt (outside the timed
        region), one warm decode step, then the best of ``reps`` timed
        steps, each between two ``torch.cuda.synchronize`` calls on the
        card.  Returns [(X, seconds)]."""
        S = min(32, self.max_len - 2)
        out = []
        for X in batch_sizes:
            _, cache = self.prefill(np.zeros((X, S), np.int32))
            tok = torch.zeros((X, 1), dtype=torch.int64, device=self.device)
            self.decode(tok, cache)
            best = float("inf")
            for _ in range(reps):
                _sync(self.device)
                t0 = time.perf_counter()
                self.decode(tok, cache)
                _sync(self.device)
                best = min(best, time.perf_counter() - t0)
            out.append((int(X), best))
        return out

    def measure_decode_delay(self, batch_sizes=(1, 2, 4, 8),
                             reps: int = 2) -> DelayModel:
        """Fit g(X) = aX + b to ``measure_decode_curve`` and adopt it."""
        curve = self.measure_decode_curve(batch_sizes, reps)
        self.delay = fit([x for x, _ in curve], [s for _, s in curve])
        return self.delay

    # ------------------------------------------------------------------
    def plan(self) -> BatchPlan:
        """Scheduler (default STACKING) over queued requests: token
        budget from deadlines."""
        svcs = [ServiceRequest(id=r.id, deadline=r.deadline,
                               spectral_eff=1.0)
                for r in self.requests.values()]
        tau_prime = {r.id: r.deadline for r in self.requests.values()}
        return self.scheduler(svcs, tau_prime, self.delay, self.quality)

    def _ensure_prefilled(self, rids: List[int]) -> None:
        todo = [rid for rid in rids if self.requests[rid].cache is None]
        if not todo:
            return
        # group equal-length prompts into one prefill call
        by_len: Dict[int, List[int]] = {}
        for rid in todo:
            by_len.setdefault(len(self.requests[rid].prompt), []).append(rid)
        for group in by_len.values():
            with obs.span("serving.prefill", rows=len(group)):
                toks = np.stack([self.requests[rid].prompt
                                 for rid in group])
                _, cache = self.prefill(toks)
                for i, rid in enumerate(group):
                    self.requests[rid].cache = _tree_map(
                        lambda ax, x: x[_slice_at(x.dim(), ax, i)],
                        self._batch_axes, cache)

    def step_batch(self, rids: List[int], timed: bool = False) -> float:
        """One batched decode step for ``rids``: gather their B=1 KV
        caches, decode, scatter back, append the argmax token.  Returns
        the wall-clock seconds of the decode step when ``timed`` (also
        logged to ``self.last_timings``); 0.0 otherwise.

        A timed step is ONE call between two ``torch.cuda.synchronize``
        calls.  The reference runs the decode twice and times the second
        (a jit warm-up); eager PyTorch needs no warm-up, and the tokens
        are the same either way."""
        with obs.span("serving.decode", rows=len(rids)):
            self._ensure_prefilled(rids)
            caches = [self.requests[rid].cache for rid in rids]
            stacked = _tree_map(lambda ax, *xs: torch.cat(xs, dim=ax),
                                self._batch_axes, *caches)
            last = np.stack(
                [[self.requests[rid].generated[-1]
                  if self.requests[rid].generated
                  else self.requests[rid].prompt[-1]] for rid in rids])
            toks = self._tokens(last)
            dt = 0.0
            if timed:
                _sync(self.device)
                t0 = time.perf_counter()
                logits, stacked = self.decode(toks, stacked)
                _sync(self.device)
                dt = time.perf_counter() - t0
                self.last_timings.append((len(rids), dt))
            else:
                logits, stacked = self.decode(toks, stacked)
            nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy()
            for i, rid in enumerate(rids):
                self.requests[rid].generated.append(int(nxt[i]))
                self.requests[rid].cache = _tree_map(
                    lambda ax, x: x[_slice_at(x.dim(), ax, i)],
                    self._batch_axes, stacked)
        return dt

    def execute(self, plan: BatchPlan,
                timed: bool = False) -> Dict[int, list]:
        """Run the plan: one batched decode_step per plan batch.

        timed: record (batch_size, seconds) per batch in
        ``self.last_timings``."""
        self.last_timings = []
        for batch in plan.batches:
            self.step_batch([k for k, _ in batch], timed=timed)
        return {rid: r.generated for rid, r in self.requests.items()}

    def open_session(self, plan: BatchPlan) -> "DecodeSession":
        """Stepwise execution handle: batches are driven one
        ``run_batch`` call at a time."""
        self.last_timings = []
        return DecodeSession(self, plan)

    def serve(self) -> Dict[int, list]:
        return self.execute(self.plan())


class DecodeSession:
    """One plan execution on a ``ServingEngine``, batch by batch.

    Decoding is memoryless per step, so ``retarget`` only has to
    validate the new token totals against the KV-cache capacity and the
    no-resurrection rule.
    """

    def __init__(self, engine: ServingEngine, plan: BatchPlan):
        self.engine = engine
        self.steps_done: Dict[int, int] = {
            k: 0 for k in plan.steps_completed}

    def run_batch(self, rids: List[int], timed: bool = False) -> float:
        dt = self.engine.step_batch(list(rids), timed=timed)
        for k in rids:
            self.steps_done[k] += 1
        return dt

    def retarget(self, totals: Dict[int, int]) -> None:
        for k, total in totals.items():
            if total < self.steps_done[k]:
                raise ValueError(
                    f"request {k}: retarget total {total} < "
                    f"{self.steps_done[k]} tokens already decoded")
            req = self.engine.requests[k]
            if len(req.prompt) + int(total) > self.engine.max_len:
                raise ValueError(
                    f"request {k}: prompt {len(req.prompt)} + "
                    f"{total} tokens exceeds max_len="
                    f"{self.engine.max_len}")

    def finish(self) -> Dict[int, list]:
        return {k: list(self.engine.requests[k].generated)
                for k in self.steps_done}
