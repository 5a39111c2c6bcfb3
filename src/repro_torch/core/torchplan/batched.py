"""``plan_many`` and ``replan_many`` — the whole Algorithm-1 T* search
over a stack of scenarios in one call on the device: the counterpart of
``repro.core.jaxplan.batched``.

Scenario sweeps and MPC-style lookahead need thousands of *small*
plans, and at that scale per-scenario dispatch, not arithmetic, is the
cost.  Stacking the scenarios into a ``(S, K)`` tau' matrix (padded to a
common K, with a validity mask) runs the clustered sweep, the power-law
scoring and the first-best selection for all S scenarios at once, with
the scenario axis as the sweep's leading tensor axis, and returns
per-scenario winning levels, counts, objectives and makespans.

Scenario rows are independent — a padded service (``valid=False`` or
tau'=0) never joins a batch and never counts in the objective.  Tau'
ties inside a scenario are broken by position (exact when ids are
0..K-1 in position order).  Materializing a chosen scenario's batch
list stays a per-scenario call: ``arrays.stacking_pass_vec(ids,
tau_prime, delay, int(res.best_level[i]))``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.quality_model import PowerLawFID
from repro_torch.core.torchplan import kernels


@dataclasses.dataclass(frozen=True)
class PlanManyResult:
    """Per-scenario outputs of one batched T* search."""
    best_level: np.ndarray   # (S,) int64 — winning T* per scenario
    steps: np.ndarray        # (S, K) int64 — completed counts T_k
    mean_fid: np.ndarray     # (S,) float64 — objective at the winner
    makespan: np.ndarray     # (S,) float64 — busy time at the winner

    @property
    def num_scenarios(self) -> int:
        return self.best_level.shape[0]


def _check_inputs(tau_prime: np.ndarray, quality,
                  offsets: Optional[np.ndarray],
                  valid: Optional[np.ndarray]):
    """Input normalization: ``(S, K)`` float64 budgets with padding
    masked inert, int64 offsets, bool validity."""
    tau_prime = np.atleast_2d(np.asarray(tau_prime, dtype=np.float64))
    S, K = tau_prime.shape
    if not isinstance(quality, PowerLawFID):
        raise TypeError("plan_many scores on the device and supports "
                        "PowerLawFID objectives only; use the "
                        "per-scenario stacking() entry point for custom "
                        "quality models")
    off = np.zeros((S, K), dtype=np.int64) if offsets is None \
        else np.broadcast_to(np.asarray(offsets, dtype=np.int64),
                             (S, K)).copy()
    vd = np.ones((S, K), dtype=bool) if valid is None \
        else np.broadcast_to(np.asarray(valid, dtype=bool), (S, K)).copy()
    taup0 = np.where(vd, tau_prime, 0.0)    # padded services are inert
    return taup0, off, vd, S, K


def _pad_stack(taup0: np.ndarray, off: np.ndarray, vd: np.ndarray,
               delay: DelayModel, t_star_max: int, Sp: int):
    """Pad a normalized ``(S, K)`` stack out to ``(Sp, Kp)`` (K to its
    bucket, S to ``Sp``) and derive every host-side input of the sweep:
    padded arrays, tie ranks, F thresholds, the padded level grid, the
    key shift and the key domain's bit count."""
    S, K = taup0.shape
    if t_star_max <= 0:
        loosest = float(taup0.max(initial=0.0))
        t_star_max = max(1, delay.max_steps(loosest))
    levels = np.arange(1, t_star_max + 1, dtype=np.int64)
    Kp, Lp = kernels._bucket(K), kernels._bucket(levels.size)
    taup_p = np.zeros((Sp, Kp), dtype=np.float64)
    taup_p[:S, :K] = taup0
    off_p = np.zeros((Sp, Kp), dtype=np.int64)
    off_p[:S, :K] = off
    vd_p = np.zeros((Sp, Kp), dtype=bool)
    vd_p[:S, :K] = vd
    lv_p = kernels._pad_tail(levels, Lp, int(levels[-1]))
    shift = max(Kp, 1).bit_length()
    tie = kernels._tie_ranks(taup_p)
    f_thr = kernels._f_threshold(taup_p, off_p, lv_p, shift,
                                 delay.a + delay.b)
    kb = kernels._key_bits(taup_p, off_p, shift, delay.a + delay.b)
    return taup_p, off_p, vd_p, tie, f_thr, lv_p, shift, kb


def _result(lv_p, S, K, best_i, counts, best_q, ms) -> PlanManyResult:
    """Copy a block's outputs to the host (one read), padding cut."""
    best = torch.cat([best_i[:, None], counts], dim=1)
    both = kernels._host(torch.cat([best.to(torch.float64),
                                    best_q[:, None], ms[:, None]], dim=1))
    best_i = both[:S, 0].astype(np.int64)
    return PlanManyResult(
        best_level=lv_p[np.maximum(best_i, 0)].astype(np.int64),
        steps=both[:S, 1:K + 1].astype(np.int64),
        mean_fid=both[:S, -2].copy(),
        makespan=both[:S, -1].copy(),
    )


def plan_many(tau_prime: np.ndarray, *, delay: DelayModel,
              quality: PowerLawFID,
              offsets: Optional[np.ndarray] = None,
              valid: Optional[np.ndarray] = None,
              t_star_max: int = 0,
              devices=None) -> PlanManyResult:
    """Plan S stacked scenarios in a single call on the device.

    ``tau_prime`` is ``(S, K)`` denoising budgets, K padded to the
    widest scenario; ``valid`` (same shape, default all-true) masks the
    padding; ``offsets`` (int, same shape) carries already-completed
    steps for replanning sweeps.  ``quality`` must be a ``PowerLawFID``
    (the paper's objective) — scoring runs on the device.
    ``t_star_max=0`` sizes the candidate grid from the loosest budget.
    It runs on ``kernels.device_scope``'s device (``"cuda"``); with
    ``devices`` (not None) the scenario axis is sharded across devices
    (``sharded.plan_many_sharded``).
    """
    if devices is not None:
        from repro_torch.core.torchplan import sharded
        return sharded.plan_many_sharded(
            tau_prime, delay=delay, quality=quality, offsets=offsets,
            valid=valid, t_star_max=t_star_max, devices=devices)
    dev = kernels.plan_device()
    taup0, off, vd, S, K = _check_inputs(tau_prime, quality, offsets,
                                         valid)
    taup_p, off_p, vd_p, tie, f_thr, lv_p, shift, kb = _pad_stack(
        taup0, off, vd, delay, t_star_max, kernels._bucket(S))
    tensors = kernels._on(dev, taup_p, off_p, vd_p, tie, f_thr, lv_p)
    out = kernels._plan_many_block(
        *tensors, shift, delay.a, delay.b, quality.alpha, quality.beta,
        quality.gamma, quality.fid_at_zero, kb)
    return _result(lv_p, S, K, *out)


def _replan_prep(taup0: np.ndarray, soff: np.ndarray, vd: np.ndarray,
                 dm: np.ndarray, delay: DelayModel, t_star_max: int,
                 Sp: int):
    """Host-side inputs of the replan block: ``_pad_stack`` with the
    pass offsets zeroed (the shared-horizon residual pass), the score
    offsets / doomed mask padded alongside, and the per-scenario
    level-validity mask capping each row's candidate grid at its own
    t_star_max — the grid the per-scenario ``stacking_vec`` sweeps."""
    S, K = taup0.shape
    step = delay.a + delay.b
    loosest = taup0.max(axis=-1, initial=0.0)
    caps = np.maximum(1, np.where(loosest > 0, loosest / step,
                                  0.0).astype(np.int64))
    if t_star_max > 0:
        caps = np.minimum(caps, t_star_max)
    taup_p, _, vd_p, tie, f_thr, lv_p, shift, kb = _pad_stack(
        taup0, np.zeros_like(soff), vd, delay,
        int(caps.max(initial=1)), Sp)
    Kp = taup_p.shape[1]
    soff_p = np.zeros((Sp, Kp), dtype=np.int64)
    soff_p[:S, :K] = soff
    dm_p = np.zeros((Sp, Kp), dtype=bool)
    dm_p[:S, :K] = dm
    caps_p = np.ones(Sp, dtype=np.int64)
    caps_p[:S] = caps
    lv_ok = lv_p[None, :] <= caps_p[:, None]
    return taup_p, soff_p, vd_p, dm_p, tie, f_thr, lv_p, lv_ok, shift, kb


def replan_many(tau_prime: np.ndarray, *, delay: DelayModel,
                quality: PowerLawFID,
                offsets: Optional[np.ndarray] = None,
                doomed: Optional[np.ndarray] = None,
                valid: Optional[np.ndarray] = None,
                t_star_max: int = 0,
                devices=None) -> PlanManyResult:
    """Batched *residual* replans: S concurrent shared-horizon replans
    (the ``repro_torch.core.online`` semantics) in one call.

    Differs from ``plan_many`` in exactly the ways a mid-flight replan
    differs from a fresh plan: the clustered pass runs with ZERO
    offsets over the residual budgets, candidates are scored
    progress-aware as ``fid(offsets + counts)`` with ``doomed`` services
    pinned at ``fid(0)`` (pass ``doomed[s, k] = offsets[s, k] > 0 and
    tau_prime[s, k] < 0``), and each scenario's candidate grid is capped
    at its own t_star_max.  The device and ``devices`` as in
    ``plan_many`` (``sharded.replan_many_sharded``).
    """
    if devices is not None:
        from repro_torch.core.torchplan import sharded
        return sharded.replan_many_sharded(
            tau_prime, delay=delay, quality=quality, offsets=offsets,
            doomed=doomed, valid=valid, t_star_max=t_star_max,
            devices=devices)
    dev = kernels.plan_device()
    taup0, soff, vd, S, K = _check_inputs(tau_prime, quality, offsets,
                                          valid)
    dm = np.zeros((S, K), dtype=bool) if doomed is None \
        else np.broadcast_to(np.asarray(doomed, dtype=bool),
                             (S, K)).copy()
    (taup_p, soff_p, vd_p, dm_p, tie, f_thr, lv_p, lv_ok, shift,
     kb) = _replan_prep(taup0, soff, vd, dm, delay, t_star_max,
                        kernels._bucket(S))
    tensors = kernels._on(dev, taup_p, soff_p, vd_p, dm_p, tie, f_thr,
                          lv_p, lv_ok)
    out = kernels._replan_many_block(
        *tensors, shift, delay.a, delay.b, quality.alpha, quality.beta,
        quality.gamma, quality.fid_at_zero, kb)
    return _result(lv_p, S, K, *out)
