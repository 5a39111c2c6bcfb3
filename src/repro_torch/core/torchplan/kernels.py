"""torch ports of the (L, K) planning sweeps: every T*/water-level
candidate advancing together, on the card — the counterpart of
``repro.core.jaxplan.kernels``.

The sweeps mirror the NumPy ones of ``repro_torch.core.arrays``
operation for operation (same float64 arithmetic, same ``1e-12``
epsilons, same composite integer keys), but torch may sum in another
order and CUDA's float64 ``pow`` may differ from libm in the last ulp,
so the contract is *tolerance* equivalence of objectives, 1e-9 mean FID
(tests/test_torch_planner.py), never bit identity.  Only completed
counts, makespans and scores come out of a sweep; the winning candidate
is materialized afterwards by the exact NumPy single-level pass.

Every float tensor is float64 by explicit dtype: torch promotes an
integer tensor mixed with a Python float to ``torch.get_default_dtype()``
(float32), where JAX under x64 gives float64, and one float32 cap or
delay would change counts, not round them.

The jitted ``lax.while_loop`` loops become host loops.  Each loop check
(``.any()`` on the card) is a device-to-host read, so the rounds run in
blocks of ``ROUNDS_PER_CHECK`` between checks: once no row is active a
round changes nothing (``x_n = 0``, ``thr = -1``, nothing packed, ``t``,
``tau'`` and counts unchanged), so surplus rounds are free of effect.
The nested drop loop needs no check at all when ``a >= 0``: after one
drop the batch shrinks, ``g`` does not grow, and every member left
already afforded the larger batch, so a second pass drops nothing
(``once`` in the sweeps; with ``a < 0`` the loop checks).  ``READS``
counts every read.

The engine runs on ``device_scope``'s device, ``"cuda"`` unless the
caller asks for another (``with device_scope("cpu"):``); without a
card, ``"cuda"`` raises.  Shapes
are padded to ``_bucket`` sizes as in the reference, and results do not
depend on the padding.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.delay_model import DelayModel

F64 = torch.float64

# same sentinel as repro_torch.core.arrays._TP_INF (not imported: this
# module must stay importable while arrays is mid-initialization during
# an env-var backend probe)
_TP_INF = np.int64(1) << 62

#: batch rounds run between two ``.any()`` checks of the round loops
ROUNDS_PER_CHECK = 4

#: device-to-host reads since the last reset: each loop check and each
#: result copied to the host is one (``chip_smoke.py`` reads it per call)
READS = {"count": 0}

_DEVICE = ["cuda"]


@contextlib.contextmanager
def device_scope(device):
    """Run the torch planner engine on ``device`` inside the block (the
    engine's one device setting, ``"cuda"`` by default): the way a
    caller asks for the CPU, ``with device_scope("cpu"): ...``.
    ``Provisioner(device=...)`` sets it around its planning."""
    prev = _DEVICE[0]
    _DEVICE[0] = device
    try:
        yield
    finally:
        _DEVICE[0] = prev


def plan_device() -> torch.device:
    """The scope's device; raises for ``"cuda"`` with no card."""
    return resolve_device(_DEVICE[0])


def _host(t: torch.Tensor) -> np.ndarray:
    """One device-to-host read."""
    READS["count"] += 1
    return t.cpu().numpy()


def _any(t: torch.Tensor) -> bool:
    """One device-to-host read: a loop check."""
    READS["count"] += 1
    return bool(t.any())


def _bucket(n: int) -> int:
    """Padded-shape buckets (the reference's): powers of two (min 8) up
    to 4096, then multiples of 2048 (K=10^4 pads to 10240, not 16384)."""
    if n <= 4096:
        return max(8, 1 << max(0, int(n - 1).bit_length()))
    return 2048 * ((int(n) + 2047) // 2048)


# -------------------------------------------------------------------------
# Per-round selection: the x_n-th smallest composite key
# -------------------------------------------------------------------------

def _select_kth_key(key, x_n, key_bits: int):
    """The ``x_n``-th smallest value of ``key`` along the last axis,
    per row, by bitwise binary search: the largest ``T`` with
    ``count(key < T) < x_n`` is that order statistic when keys are
    unique integers (they are: every active key embeds a distinct tie
    rank, and x_n never exceeds the active count).  ``key_bits`` bounds
    the real-key domain; rows with ``x_n == 0`` return 0 and must be
    masked by the caller."""
    thr = torch.zeros(key.shape[:-1], dtype=key.dtype, device=key.device)
    for i in range(key_bits):
        cand = thr | (1 << (key_bits - 1 - i))
        cnt = (key < cand[..., None]).sum(dim=-1)
        thr = torch.where(cnt < x_n, cand, thr)
    return thr


def _sort_kth_key(key, x_n, key_bits: Optional[int] = None):
    """The same order statistic through a full sort of each row
    (``key_bits`` unused: the signature is ``_select``'s)."""
    srt = torch.sort(key, dim=-1).values
    return srt.gather(-1, (x_n - 1).clamp(min=0)[..., None])[..., 0]


#: the selection the clustered sweep uses (see PERF.md §6 for the
#: timing that picked it)
_select = _sort_kth_key


def _key_bits(taup0: np.ndarray, off: np.ndarray, shift: int,
              step_cost: float) -> int:
    """Bit width of the composite-key domain for a (possibly
    scenario-stacked) instance: real keys are ``Tp * M + tie`` with
    ``Tp <= tp_bound`` (the bound ``_f_threshold`` clamps to)."""
    M = np.int64(1) << np.int64(shift)
    te0_max = np.int64(np.max(np.maximum(taup0, 0.0), initial=0.0)
                       / step_cost)
    tp_bound = np.int64(np.max(off, initial=0) if off.size else 0) \
        + 2 * te0_max + 4
    return max(1, int((tp_bound + 1) * M - 1).bit_length())


# -------------------------------------------------------------------------
# The clustered (Algorithm-1) sweep
# -------------------------------------------------------------------------

def _clustered_core(taup0, off, levels, tie, f_thr, shift: int,
                    a: float, b: float, key_bits: int):
    """Algorithm-1 rounds of S scenarios over L candidate levels:
    ``taup0 (S, K) float64, off (S, K) int64, levels (L,) int64, tie
    (S, K) int64, f_thr (S, L) int64`` -> ``(Tc (S, L, K) int64,
    makespan (S, L) float64)``.  The port of the reference's
    ``_clustered_chunk`` with the scenario axis its ``vmap`` adds and
    all levels in one loop."""
    S, K = taup0.shape
    L = levels.shape[0]
    dev = taup0.device
    g1 = a * 1 + b                       # delay.min_task_delay()
    step_cost = a + b
    # int32 integer state whenever the key domain allows it
    idt = torch.int32 if key_bits <= 31 else torch.int64
    sent = torch.iinfo(idt).max          # past every real key
    M = 1 << shift
    tie_i = tie.to(idt)[:, None, :]
    f_thr_i = f_thr.to(idt)[:, :, None]
    off_i = off.to(idt)[:, None, :]

    lv_pos = levels > 0
    lv_f = levels.to(F64)
    b_lv = b * lv_f
    a_lv = a * lv_f.clamp(min=1.0)

    taup = taup0[:, None, :].expand(S, L, K).clone()
    Tc = torch.zeros((S, L, K), dtype=idt, device=dev)
    active = (taup0 >= g1)[:, None, :].expand(S, L, K).clone()
    t = torch.zeros((S, L), dtype=F64, device=dev)
    once = a >= 0.0                      # one drop pass is the fixed point

    def round_(taup, Tc, active, t):
        # ---- clustering (Eqs. 15-18, offset-shifted) -----------------
        Te = (taup / step_cost).to(idt)
        Tp = off_i + Tc + Te
        key = torch.where(active, Tp * M + tie_i, sent)

        n_active = active.sum(dim=-1).to(F64)
        F = key <= f_thr_i
        n_F = F.sum(dim=-1)

        # ---- packing (Eqs. 19-20) ------------------------------------
        te_max = torch.where(F, Te, -1).amax(dim=-1).to(F64)
        tau_min = torch.where(F, taup, torch.inf).amin(dim=-1)
        cap_f = torch.floor((tau_min - b * te_max)
                            / (a * te_max.clamp(min=1.0)))
        tp_min = (key.amin(dim=-1) >> shift).to(F64)
        cap_nf = torch.floor((step_cost * tp_min - b_lv) / a_lv)
        n_F_f = n_F.to(F64)
        x_f = torch.where(te_max > 0,
                          torch.maximum(n_F_f,
                                        torch.minimum(n_active, cap_f)),
                          n_F_f)
        x_nf = torch.minimum(n_active,
                             torch.where(lv_pos, cap_nf.clamp(min=1.0),
                                         n_active))
        x_n = torch.where(n_F > 0, x_f, x_nf)
        x_n = torch.minimum(x_n, n_active).clamp(min=1.0)
        x_n = torch.where(n_active > 0, x_n, 0.0).to(torch.int64)

        # ---- batching -------------------------------------------------
        thr = _select(key, x_n, key_bits)
        thr = torch.where(x_n > 0, thr, -1)
        packed = key <= thr[..., None]
        n_packed = x_n
        while True:
            g = a * n_packed.to(F64) + b
            drop = packed & (taup + 1e-12 < g[..., None])
            packed = packed & ~drop         # cannot afford this batch ->
            active = active & ~drop         # service is finished
            n_packed = packed.sum(dim=-1)
            if once or not _any(drop):
                break

        has_batch = n_packed > 0
        g = a * n_packed.to(F64) + b
        t = t + torch.where(has_batch, g, 0.0)
        adv = active & has_batch[..., None]  # wall clock advances for all
        taup = taup - torch.where(adv, g[..., None], 0.0)    # (Eq. 15)
        Tc = Tc + packed.to(idt)
        # services that can no longer fit even a dedicated batch are done
        active = active & (taup + 1e-12 >= g1)
        return taup, Tc, active, t

    while _any(active):
        for _ in range(ROUNDS_PER_CHECK):
            taup, Tc, active, t = round_(taup, Tc, active, t)
    return Tc.to(torch.int64), t


# -------------------------------------------------------------------------
# The lockstep sweep (equal_steps / offset_pass targets)
# -------------------------------------------------------------------------

def _lockstep_core(taup0, targets, a: float, b: float):
    """One scenario's lockstep rounds over all L target rows:
    ``(taup0 (K,) float64, targets (L, K) int64)`` -> ``(Tc (L, K)
    int64, makespan (L,) float64)``.  The port of ``arrays.
    _lockstep_rounds`` (and the reference's ``_lockstep_core``)."""
    L, K = targets.shape
    g1 = a * 1 + b
    once = a >= 0.0                      # one drop pass is the fixed point

    taup = taup0[None, :].expand(L, K).clone()
    Tc = torch.zeros((L, K), dtype=torch.int64, device=taup0.device)
    active = (targets > 0) & (taup0 >= g1)[None, :]
    t = torch.zeros((L,), dtype=F64, device=taup0.device)

    def round_(taup, Tc, active, t):
        n = active.sum(dim=-1)
        while True:
            g = a * n.to(F64) + b
            drop = active & (taup + 1e-12 < g[:, None])
            active = active & ~drop
            n = active.sum(dim=-1)
            if once or not _any(drop):
                break
        has_batch = n > 0
        g = a * n.to(F64) + b
        t = t + torch.where(has_batch, g, 0.0)
        taup = taup - torch.where(active, g[:, None], 0.0)
        Tc = Tc + active.to(torch.int64)
        active = active & (Tc < targets) & (taup + 1e-12 >= g1)
        return taup, Tc, active, t

    while _any(active):
        for _ in range(ROUNDS_PER_CHECK):
            taup, Tc, active, t = round_(taup, Tc, active, t)
    return Tc, t


# -------------------------------------------------------------------------
# Scoring + selection (PowerLawFID only)
# -------------------------------------------------------------------------

def _powerlaw_rows(Tc, offsets, valid, doomed, alpha: float, beta: float,
                   gamma: float, fid0: float):
    """Masked progress-aware mean FID of every row: ``Tc (..., L, K)``
    with ``offsets``, ``valid``, ``doomed`` ``(..., K)`` -> ``(..., L)``:
    ``fid(offset + count)`` with the ``doomed -> fid(0)`` rule,
    averaged over ``valid`` services only (pad services excluded)."""
    tot = Tc + offsets[..., None, :]
    f = torch.where(tot > 0, alpha * tot.to(F64).pow(-beta) + gamma, fid0)
    f = torch.where(doomed[..., None, :], fid0, f)
    f = torch.where(valid[..., None, :], f, 0.0)
    n = valid.sum(dim=-1).clamp(min=1).to(F64)
    return f.sum(dim=-1) / n[..., None]


#: S rows per pass of ``_first_best``'s (S, L+1, L+1) comparison table
_FIRST_BEST_CELLS = 1 << 26


def _first_best(qs, valid_rows):
    """The scalar searches' selection rule — the FIRST candidate
    strictly better (by 1e-12) than everything before it — for every
    row of ``qs (S, L)``; ``valid_rows (L,)`` or ``(S, L)`` masks
    candidates out.  Returns ``(best_i (S,) int64, -1 if none; best_q
    (S,) float64, inf if none)``.

    Not ``argmin``: with the 1e-12 slack the winner depends on the
    order.  The rule is a chain: from the current best ``i`` (start: a
    virtual candidate at ``q = inf``) the next pick is the first later
    valid ``j`` with ``q_j < q_i - 1e-12``, and the answer is the
    chain's end.  ``nxt`` holds each candidate's successor (itself at
    the end); indices only grow along the chain, so after
    ``ceil(log2(L + 1))`` squarings ``nxt[0]`` is the end."""
    S, L = qs.shape
    dev = qs.device
    valid_rows = valid_rows.expand(S, L)
    rows = max(1, _FIRST_BEST_CELLS // (L + 1) ** 2)
    if S > rows:
        parts = [_first_best(qs[i:i + rows], valid_rows[i:i + rows])
                 for i in range(0, S, rows)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))
    q = torch.cat([torch.full((S, 1), torch.inf, dtype=F64, device=dev),
                   qs.to(F64)], dim=1)
    ok = torch.cat([torch.ones((S, 1), dtype=torch.bool, device=dev),
                    valid_rows], dim=1)
    idx = torch.arange(L + 1, device=dev)
    later = idx[None, :] > idx[:, None]
    better = ok[:, None, :] & later[None] \
        & (q[:, None, :] < q[:, :, None] - 1e-12)
    nxt = torch.where(better.any(dim=-1),
                      better.to(torch.uint8).argmax(dim=-1),
                      idx[None, :])
    for _ in range(max(1, L.bit_length())):
        nxt = nxt.gather(1, nxt)
    end = nxt[:, 0]
    return end - 1, q.gather(1, end[:, None])[:, 0]


# -------------------------------------------------------------------------
# Host-side preparation (NumPy, as in the reference)
# -------------------------------------------------------------------------

def _tie_ranks(taup0: np.ndarray,
               ids: Optional[np.ndarray] = None) -> np.ndarray:
    """The round-invariant (tau', id) tie-break of ``arrays``, as an
    integer rank per service.  ``ids`` breaks tau' ties for the
    single-scenario wrappers; batched callers (row position == id)
    rely on the stable argsort instead."""
    if ids is not None:
        order = np.lexsort((ids, taup0))
        tie = np.empty(taup0.size, dtype=np.int64)
        tie[order] = np.arange(taup0.size, dtype=np.int64)
        return tie
    order = np.argsort(taup0, axis=-1, kind="stable")
    tie = np.empty_like(order, dtype=np.int64)
    np.put_along_axis(tie, order,
                      np.broadcast_to(
                          np.arange(taup0.shape[-1], dtype=np.int64),
                          order.shape).copy(), axis=-1)
    return tie


def _f_threshold(taup0: np.ndarray, off: np.ndarray, levels: np.ndarray,
                 shift: int, step_cost: float) -> np.ndarray:
    """The priority-cluster membership threshold in composite-key
    space (``key <= lv*M + (M-1)  <=>  Tp <= lv``), clamped to the Tp
    bound so the int64 keys stay far from overflow.  Batched over a
    leading scenario axis when present."""
    M = np.int64(1) << shift
    te0_max = np.floor(np.max(np.maximum(taup0, 0.0), axis=-1)
                       / step_cost).astype(np.int64)
    tp_bound = (off.max(axis=-1) if off.size else np.int64(0)) \
        + 2 * te0_max + 4
    if not int(np.max(tp_bound, initial=0) + 2) * int(M) < int(_TP_INF):
        raise AssertionError("key space overflow")
    lv = levels[..., :] if taup0.ndim == 1 else levels[None, :]
    bound = tp_bound if taup0.ndim == 1 else tp_bound[:, None]
    return np.where(lv >= 0, np.minimum(lv, bound) * M + (M - 1),
                    np.int64(-1))


def _pad_tail(arr: np.ndarray, n: int, value) -> np.ndarray:
    """Pad the last axis out to ``n`` with ``value``."""
    if arr.shape[-1] == n:
        return arr
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, n - arr.shape[-1])]
    return np.pad(arr, pad, constant_values=value)


def _on(dev, *arrays):
    """NumPy arrays as tensors on ``dev`` (host-to-device copies)."""
    return tuple(torch.as_tensor(np.ascontiguousarray(x), device=dev)
                 for x in arrays)


# -------------------------------------------------------------------------
# Single-scenario sweeps
# -------------------------------------------------------------------------

def clustered_sweep(taup0: np.ndarray, off: np.ndarray, levels: np.ndarray,
                    delay: DelayModel, ids: Optional[np.ndarray] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Algorithm-1 sweep of one scenario on the device: completed
    counts ``(L, K)`` and makespans ``(L,)`` for every candidate level,
    as tensors on the device.  Shapes are bucket-padded (extra services
    inactive at tau'=0, extra levels repeating the last real level) and
    the padding sliced off."""
    dev = plan_device()
    taup0 = np.asarray(taup0, dtype=np.float64)
    off = np.asarray(off, dtype=np.int64)
    levels = np.asarray(levels, dtype=np.int64)
    K, L = taup0.size, levels.size
    Kp, Lp = _bucket(K), _bucket(L)
    taup_p = _pad_tail(taup0, Kp, 0.0)
    off_p = _pad_tail(off, Kp, 0)
    lv_p = _pad_tail(levels, Lp, int(levels[-1]) if L else 1)
    shift = max(Kp, 1).bit_length()
    ids_p = None if ids is None else \
        _pad_tail(np.asarray(ids, dtype=np.int64), Kp,
                  int(np.max(ids, initial=0)) + 1)
    tie = _tie_ranks(taup_p, ids_p)
    step = delay.a + delay.b
    f_thr = _f_threshold(taup_p, off_p, lv_p, shift, step)
    kb = _key_bits(taup_p, off_p, shift, step)
    tp_t, off_t, lv_t, tie_t, f_t = _on(dev, taup_p[None], off_p[None],
                                        lv_p, tie[None], f_thr[None])
    Tc, t = _clustered_core(tp_t, off_t, lv_t, tie_t, f_t, shift,
                            delay.a, delay.b, kb)
    return Tc[0, :L, :K], t[0, :L]


def lockstep_sweep(taup0: np.ndarray, targets: np.ndarray,
                   delay: DelayModel
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lockstep sweep of one scenario on the device: counts and
    makespans for every ``(L, K)`` additional-step target row (padded
    services carry target 0, so they never join a batch)."""
    dev = plan_device()
    taup0 = np.asarray(taup0, dtype=np.float64)
    targets = np.asarray(targets, dtype=np.int64)
    L, K = targets.shape
    Kp, Lp = _bucket(K), _bucket(L)
    taup_p = _pad_tail(taup0, Kp, 0.0)
    tg_p = _pad_tail(targets, Kp, 0)
    tg_p = np.pad(tg_p, [(0, Lp - L), (0, 0)], constant_values=0)
    tp_t, tg_t = _on(dev, taup_p, tg_p)
    Tc, t = _lockstep_core(tp_t, tg_t, delay.a, delay.b)
    return Tc[:L, :K], t[:L]


def powerlaw_rows(Tc: torch.Tensor, quality,
                  offsets: Optional[np.ndarray] = None,
                  doomed: Optional[np.ndarray] = None,
                  valid: Optional[np.ndarray] = None) -> torch.Tensor:
    """``_powerlaw_rows`` of a ``(L, K)`` count tensor on its device,
    with NumPy ``offsets``/``doomed``/``valid`` (default zero, False,
    True)."""
    K = Tc.shape[-1]
    off = np.zeros(K, np.int64) if offsets is None \
        else np.asarray(offsets, np.int64)
    dm = np.zeros(K, bool) if doomed is None else np.asarray(doomed, bool)
    vd = np.ones(K, bool) if valid is None else np.asarray(valid, bool)
    off_t, dm_t, vd_t = _on(Tc.device, off, dm, vd)
    return _powerlaw_rows(Tc, off_t, vd_t, dm_t, quality.alpha,
                          quality.beta, quality.gamma, quality.fid_at_zero)


def clustered_counts(taup0: np.ndarray, off: np.ndarray,
                     levels: np.ndarray, delay: DelayModel,
                     ids: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``clustered_sweep`` with NumPy results: completed counts
    ``(L, K)`` and makespans ``(L,)`` for every candidate level."""
    Tc, t = clustered_sweep(taup0, off, levels, delay, ids)
    return _host(Tc), _host(t)


def lockstep_counts(taup0: np.ndarray, targets: np.ndarray,
                    delay: DelayModel
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """``lockstep_sweep`` with NumPy results."""
    Tc, t = lockstep_sweep(taup0, targets, delay)
    return _host(Tc), _host(t)


def powerlaw_scores(Tc: np.ndarray, quality, offsets: Optional[np.ndarray],
                    doomed: Optional[np.ndarray] = None,
                    valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Row scores of a NumPy count matrix for a PowerLawFID-based
    objective, computed on the device; callers fall back to
    ``arrays.score_rows`` for arbitrary quality models."""
    Tc_t, = _on(plan_device(), np.asarray(Tc, dtype=np.int64))
    return _host(powerlaw_rows(Tc_t, quality, offsets, doomed, valid))


# -------------------------------------------------------------------------
# The batched searches (plan_many / replan_many)
# -------------------------------------------------------------------------

def _pick(Tc, t, best_i):
    """Each scenario's counts and makespan at its winning level."""
    idx = best_i.clamp(min=0)
    rows = torch.arange(Tc.shape[0], device=Tc.device)
    return Tc[rows, idx], t[rows, idx]


def _plan_many_block(taup0, off, valid, tie, f_thr, levels, shift, a, b,
                     alpha, beta, gamma, fid0, key_bits):
    """One T* search over S stacked scenarios: the clustered sweep with
    the offsets in the pass, power-law scoring, the first-best rule.
    Returns ``(best_i (S,), counts (S, K), best_q (S,), makespan
    (S,))``."""
    Tc, t = _clustered_core(taup0, off, levels, tie, f_thr, shift, a, b,
                            key_bits)
    qs = _powerlaw_rows(Tc, off, valid, torch.zeros_like(valid), alpha,
                        beta, gamma, fid0)
    best_i, best_q = _first_best(
        qs, torch.ones(levels.shape[0], dtype=torch.bool,
                       device=qs.device))
    counts, ms = _pick(Tc, t, best_i)
    return best_i, counts, best_q, ms


def _replan_many_block(taup0, score_off, valid, doomed, tie, f_thr,
                       levels, lv_ok, shift, a, b, alpha, beta, gamma,
                       fid0, key_bits):
    """S concurrent residual replans (``repro_torch.core.online``'s
    shared-horizon semantics): the clustered pass with ZERO offsets over
    the residual budgets, candidates scored as ``fid(done + new)`` with
    ``doomed -> fid(0)``, each scenario's grid capped at its own
    t_star_max (``lv_ok``)."""
    Tc, t = _clustered_core(taup0, torch.zeros_like(score_off), levels,
                            tie, f_thr, shift, a, b, key_bits)
    qs = _powerlaw_rows(Tc, score_off, valid, doomed, alpha, beta, gamma,
                        fid0)
    best_i, best_q = _first_best(qs, lv_ok)
    counts, ms = _pick(Tc, t, best_i)
    return best_i, counts, best_q, ms
