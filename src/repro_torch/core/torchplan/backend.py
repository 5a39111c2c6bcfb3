"""The "torch" planner engine: the outer searches on the device behind
the entry points the vec/scalar engines dispatch through — the
counterpart of ``repro.core.jaxplan.backend``.

Each search runs its candidate sweep on the device
(``repro_torch.core.torchplan.kernels``), scores the resulting
``(L, K)`` count matrix there when the quality model is the paper's
``PowerLawFID`` (through the exact scalar calls on the host otherwise),
copies the scores to the host, applies the scalar searches'
first-strictly-better rule, and materializes only the winning candidate
via the exact NumPy single-level pass of ``repro_torch.core.arrays``.
Returned plans are therefore always valid ``BatchPlan``s built by the
code every other engine uses; what may differ from vec/scalar, within
1e-9 mean FID, is *which* candidate wins when two levels score within
~1e-12 of each other.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core import arrays
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import PowerLawFID
from repro_torch.core.torchplan import kernels


def _score(Tc: torch.Tensor, quality) -> np.ndarray:
    """Row scores of a device count matrix: the power-law scorer on the
    device for a bare ``PowerLawFID`` (one read: the scores), else
    ``arrays.score_rows`` on the host (one read: the counts).  Wrapped
    objectives — notably the replanner's ``_OffsetQuality`` — are never
    unwrapped here: ``offset_plan`` rebuilds that objective itself."""
    if type(quality) is PowerLawFID:
        return kernels._host(kernels.powerlaw_rows(Tc, quality))
    return arrays.score_rows(kernels._host(Tc), quality)


def _first_best(qs: np.ndarray) -> int:
    """First candidate strictly better (by 1e-12) than everything
    before it — the scalar searches' selection rule, on the host."""
    best_i, best_q = -1, float("inf")
    for i, q in enumerate(qs.tolist()):
        if q < best_q - 1e-12:
            best_i, best_q = i, q
    return best_i


def stacking(services, tau_prime: Dict[int, float], delay: DelayModel,
             quality, t_star_max: int = 0) -> BatchPlan:
    """Algorithm 1 with the outer T* search as one device sweep; the
    winning level is materialized by the exact NumPy pass."""
    ids = [s.id for s in services]
    if t_star_max <= 0:
        t_star_max = max(1, max(delay.max_steps(tau_prime[k])
                                for k in ids))
    arr = arrays.ServiceArrays.build(ids, tau_prime)
    levels = np.arange(1, t_star_max + 1, dtype=np.int64)
    Tc, _ = kernels.clustered_sweep(arr.tau_prime, arr.offsets, levels,
                                    delay, ids=arr.ids)
    best = _first_best(_score(Tc, quality))
    if best < 0:
        raise ValueError("stacking: no T* candidate produced a plan")
    return arrays.stacking_pass_vec(ids, tau_prime, delay,
                                    int(levels[best]))


def equal_steps(services, tau_prime: Dict[int, float], delay: DelayModel,
                quality) -> BatchPlan:
    """The balanced baseline with its shared-target search as one
    device lockstep sweep (row l targets T* = l + 1 for everyone)."""
    ids = [s.id for s in services]
    feasible = [k for k in ids if delay.max_steps(tau_prime[k]) > 0]
    t_max = max([delay.max_steps(tau_prime[k]) for k in feasible],
                default=1)
    arr = arrays.ServiceArrays.build(ids, tau_prime)
    levels = np.arange(1, max(1, t_max) + 1, dtype=np.int64)
    targets = np.broadcast_to(levels[:, None],
                              (levels.size, arr.K)).copy()
    Tc, _ = kernels.lockstep_sweep(arr.tau_prime, targets, delay)
    best = _first_best(_score(Tc, quality))
    if best < 0:
        raise ValueError("equal_steps: no level produced a plan")
    level = int(levels[best])
    return arrays.offset_pass_vec(ids, tau_prime, delay,
                                  {k: level for k in ids})


def offset_plan(ids: Sequence[int], tau_prime: Dict[int, float],
                delay: DelayModel, oq, off: Dict[int, int],
                level_max: int, t_new_max: int) -> BatchPlan:
    """``StackingOffset``'s three candidate families, each swept on the
    device and scored under the progress-aware objective
    (``_OffsetQuality``: ``fid(done + new)`` with the doomed rule), with
    the scalar tie rule — objective first, shorter makespan among
    objective-equal candidates."""
    arr = arrays.ServiceArrays.build(ids, tau_prime, off)
    off_vec = arr.offsets
    doomed = np.zeros(arr.K, dtype=bool)
    for i in getattr(oq, "doomed", ()):
        doomed[i] = True
    # the _OffsetQuality objective rebuilt for the device scorer; other
    # bases take the exact score_rows path
    base = getattr(oq, "base", None)
    if type(base) is not PowerLawFID:
        base = None

    def scored(Tc: torch.Tensor, ms: torch.Tensor):
        """(scores, makespans) on the host: one read for both with the
        device scorer."""
        if base is not None:
            q = kernels.powerlaw_rows(Tc, base, off_vec, doomed)
            both = kernels._host(torch.stack([q, ms]))
            return both[0], both[1]
        return arrays.score_rows(kernels._host(Tc), oq), kernels._host(ms)

    state = {"q": oq.mean_fid([0] * len(ids)), "ms": 0.0,
             "pick": None}        # None = the all-retire empty plan

    def consider(q: float, ms: float, pick) -> None:
        if q < state["q"] - 1e-12 or \
                (q < state["q"] + 1e-12 and ms < state["ms"] - 1e-12):
            state.update(q=q, ms=ms, pick=pick)

    levels = np.arange(1, level_max + 1, dtype=np.int64)
    # family 1 — Algorithm 1 clustered on TOTAL counts
    q1, ms1 = scored(*kernels.clustered_sweep(arr.tau_prime, off_vec,
                                              levels, delay, ids=arr.ids))
    for i, q in enumerate(q1.tolist()):
        consider(q, float(ms1[i]), ("clustered", i))

    # family 2 — lockstep water-filling over the total-step level
    targets = np.maximum(levels[:, None] - off_vec[None, :], 0)
    nonzero = targets.any(axis=1)
    q2, ms2 = scored(*kernels.lockstep_sweep(arr.tau_prime, targets,
                                             delay))
    for i, q in enumerate(q2.tolist()):
        if nonzero[i]:
            consider(q, float(ms2[i]), ("lockstep", i))

    # family 3 — shared-NEW-horizon Algorithm 1 candidates
    levels3 = np.arange(1, t_new_max + 1, dtype=np.int64)
    q3, ms3 = scored(*kernels.clustered_sweep(
        arr.tau_prime, np.zeros(arr.K, dtype=np.int64), levels3, delay,
        ids=arr.ids))
    for i, q in enumerate(q3.tolist()):
        consider(q, float(ms3[i]), ("shared", i))

    pick = state["pick"]
    if pick is None:
        return BatchPlan(batches=[], start_times=[],
                         steps_completed={k: 0 for k in ids},
                         delay=delay)
    family, i = pick
    if family == "clustered":
        return arrays.stacking_pass_vec(ids, tau_prime, delay,
                                        int(levels[i]), offsets=off)
    if family == "lockstep":
        tgt = {k: max(0, int(levels[i]) - off.get(k, 0)) for k in ids}
        return arrays.offset_pass_vec(ids, tau_prime, delay, tgt)
    return arrays.stacking_pass_vec(ids, tau_prime, delay,
                                    int(levels3[i]))
