"""Array-native planning engine: the vectorized STACKING core.

A copy of ``repro.core.arrays``.  Every planning hot path reduces to two
inner sweeps: the *clustered* sweep (Algorithm 1's clustering/packing/
batching rounds for one T*, optionally offset-shifted into total-step
space, ``repro_torch.core.offset``) and the *lockstep* sweep (every
still-short service joins every batch until it reaches its target;
``equal_steps`` and ``offset_pass``).  A scenario's per-service state
lives in contiguous NumPy arrays (``ServiceArrays``) and both sweeps run
as masked array kernels over ALL candidate levels at once: ``(L, K)``
state, one python iteration per batch round.

Bit-identical to the scalar loops by construction (same float64
operations in the same order, same 1e-12 epsilons, same (Tp, tau', id)
sort keys); tests/test_torch_planner.py holds them ``==``.

Engine selection: the consumers (``stacking``, ``equal_steps``,
``StackingOffset``, ``optimal_plan`` and the online and closed-loop
pipelines) dispatch on the process-wide engine, ``"vec"`` by default.

    from repro_torch.core import arrays
    arrays.set_engine("scalar")          # global: reference path
    with arrays.engine_scope("torch"):   # scoped override
        ...

or per call via their ``engine=`` parameter; the ``REPRO_PLANNER_ENGINE``
environment variable sets the process default.  ``"torch"`` is the
optional device backend ``repro_torch.core.torchplan``, probed on first
request; it runs on the card unless ``torchplan.device_scope("cpu")``
asks for the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan

# int64 sentinel pushing inactive services past every real Tp in the
# (Tp, tau', id) lexsort; far below int64 overflow when summed with keys
_TP_INF = np.int64(1) << 62


# -------------------------------------------------------------------------
# Engine registry
# -------------------------------------------------------------------------
#
# One extensible name -> implementation map shared by ``set_engine``,
# ``resolve_engine`` and the ``REPRO_PLANNER_ENGINE`` guard.  The two
# built-in engines ("vec", "scalar") register ``None`` — their dispatch
# lives inline in the consumers — while optional backends register an
# implementation object whose attributes (``stacking``, ``equal_steps``,
# ``offset_plan``, ``optimal_plan``) the consumers call instead
# (``repro_torch.core.torchplan`` registers the "torch" engine this way).

_ENGINE_IMPLS: Dict[str, Optional[Any]] = {}
_BACKENDS_PROBED = False
_BACKEND_ERRORS: Dict[str, str] = {}
# optional backend modules probed on first unknown-engine lookup, so
# ``REPRO_PLANNER_ENGINE=torch`` (or ``set_engine("torch")``) works without
# anyone importing the backend first — and without paying its import
# cost when nobody asks for it
_OPTIONAL_BACKENDS = {"torch": "repro_torch.core.torchplan"}


def register_engine(name: str, impl: Optional[Any] = None) -> None:
    """Register a planner engine.  ``impl`` is ``None`` for the
    built-in engines (dispatched inline by the consumers) or a backend
    namespace providing ``stacking`` / ``equal_steps`` /
    ``offset_plan`` / ``optimal_plan`` entry points."""
    if name in _ENGINE_IMPLS and _ENGINE_IMPLS[name] is not impl:
        raise ValueError(f"planner engine {name!r} is already registered")
    _ENGINE_IMPLS[name] = impl


register_engine("vec")
register_engine("scalar")


def registered_engines() -> Tuple[str, ...]:
    """The currently registered engine names, sorted.  Optional
    backends appear once imported (or once first requested by name)."""
    return tuple(sorted(_ENGINE_IMPLS))


def _probe_backends() -> None:
    """Import the optional backend modules once so they can register
    their engines; a backend whose dependency is missing records the
    reason for the error message instead of failing the probe."""
    global _BACKENDS_PROBED
    if _BACKENDS_PROBED:
        return
    _BACKENDS_PROBED = True
    for eng, module in _OPTIONAL_BACKENDS.items():
        try:
            importlib.import_module(module)
        except ImportError as e:      # dependency absent: engine stays
            _BACKEND_ERRORS[eng] = str(e)   # unregistered, reason kept


def _require_engine(name: str) -> str:
    """Validate an engine name against the registry (probing optional
    backends on a miss), raising with the dynamic engine list."""
    if name not in _ENGINE_IMPLS:
        _probe_backends()
    if name not in _ENGINE_IMPLS:
        hint = (f" (backend unavailable: {_BACKEND_ERRORS[name]})"
                if name in _BACKEND_ERRORS else "")
        raise ValueError(
            f"unknown planner engine {name!r}; registered engines: "
            f"{', '.join(registered_engines())}{hint}")
    return name


def engine_impl(name: str) -> Optional[Any]:
    """The backend implementation registered for ``name`` (``None``
    for the built-in vec/scalar engines)."""
    return _ENGINE_IMPLS[_require_engine(name)]


def get_engine() -> str:
    """The process-wide planning engine ("vec" by default)."""
    return _ENGINE


def set_engine(name: str) -> None:
    """Select the process-wide planning engine."""
    global _ENGINE
    _ENGINE = _require_engine(name)


@contextlib.contextmanager
def engine_scope(name: Optional[str]):
    """Temporarily select an engine (``None`` = leave as-is).  The
    online/multi-server pipelines use this to honour their ``engine=``
    parameter around a whole event-driven run."""
    if name is None:
        yield
        return
    prev = get_engine()
    set_engine(name)
    try:
        yield
    finally:
        set_engine(prev)


def resolve_engine(engine: Optional[str]) -> str:
    """An explicit ``engine=`` argument, or the process default."""
    if engine is None:
        return get_engine()
    return _require_engine(engine)


# -------------------------------------------------------------------------
# Per-service state as contiguous arrays
# -------------------------------------------------------------------------

@dataclasses.dataclass
class ServiceArrays:
    """A scenario's per-service planning state in contiguous arrays,
    rows in the given service order (the ``make_plan`` convention every
    objective evaluation relies on)."""

    ids: np.ndarray          # (K,) int64 service ids
    tau_prime: np.ndarray    # (K,) float64 generation budgets
    offsets: np.ndarray      # (K,) int64 steps already executed
    index: Dict[int, int]    # id -> row

    @property
    def K(self) -> int:
        return int(self.ids.size)

    @classmethod
    def build(cls, service_ids: Sequence[int],
              tau_prime: Dict[int, float],
              offsets: Optional[Dict[int, int]] = None) -> "ServiceArrays":
        ids = np.asarray([int(k) for k in service_ids], dtype=np.int64)
        taup = np.asarray([float(tau_prime[int(k)]) for k in ids],
                          dtype=np.float64)
        if offsets:
            off = np.asarray([int(offsets.get(int(k), 0)) for k in ids],
                             dtype=np.int64)
        else:
            off = np.zeros(ids.size, dtype=np.int64)
        return cls(ids=ids, tau_prime=taup, offsets=off,
                   index={int(k): i for i, k in enumerate(ids)})


# -------------------------------------------------------------------------
# Kernels: (L, K) state, one python iteration per batch round
# -------------------------------------------------------------------------

def _clustered_rounds(ids: np.ndarray, taup0: np.ndarray, off: np.ndarray,
                      delay: DelayModel, levels: np.ndarray,
                      record: bool = False,
                      history: Optional[list] = None):
    """The Algorithm-1 clustering/packing/batching rounds, batched over
    candidate levels: row l plans against T* = ``levels[l]``.

    Returns ``(Tc, makespan, batches, start_times)`` — ``Tc`` is
    ``(L, K)`` completed counts, ``makespan`` ``(L,)``.  ``record=True``
    (single level only) additionally materializes the batch list in the
    scalar pass's exact order (sorted-cluster sequence).  ``history``
    (a caller-owned list) collects per-round ``(order, packed, x_n,
    has_batch)`` snapshots so the outer searches can replay ANY row's
    batch list afterwards (``_replay_clustered``) without re-running a
    pass for the winning candidate.
    """
    a, b = delay.a, delay.b
    levels = np.asarray(levels, dtype=np.int64)
    L, K = levels.size, taup0.size
    assert not record or L == 1, "batch recording needs a single level"
    g1 = delay.min_task_delay()          # == a * 1 + b
    step_cost = a + b                    # T^e divisor (size-1 batches)
    taup0 = np.asarray(taup0, dtype=np.float64)

    # The round-invariant tie-break: every committed batch subtracts the
    # SAME g from every active service of a row (Eq. 15) and inactive
    # services never re-activate, so pairwise tau' differences among
    # active services equal their initial differences — the (tau', id)
    # order the scalar sort breaks Tp ties with never changes.  Encoding
    # it once as an integer rank turns the per-round 3-key lexsort into
    # a values-only sort of ONE composite integer key,
    #     key = Tp * M + tie_rank        (unique per service),
    # whose x_n-th smallest value is a membership threshold.
    tie = np.empty(K, dtype=np.int64)
    tie[np.lexsort((ids, taup0))] = np.arange(K, dtype=np.int64)
    shift = int(max(K, 1).bit_length())
    M = np.int64(1) << shift

    taup = np.tile(taup0, (L, 1))
    Tc = np.zeros((L, K), dtype=np.int64)
    active = np.tile(taup0 >= g1, (L, 1))
    t = np.zeros(L, dtype=np.float64)
    off2 = off[None, :]
    # level-constant packing terms, hoisted out of the round loop (the
    # divisor clamp only changes masked-out values for levels <= 0)
    lv_pos = levels > 0
    b_lv = b * levels.astype(np.float64)
    a_lv = a * np.maximum(levels.astype(np.float64), 1.0)
    # the F threshold in key space: key <= lv*M + (M-1)  <=>  Tp <= lv.
    # Tp is bounded by off + 2*T^e0 + slack (T_c can't outgrow the
    # dedicated-batch bound), so clamping huge direct-call levels there
    # changes nothing and keeps the int64 key far from overflow
    te0_max = int(np.max(np.maximum(taup0, 0.0)) / step_cost) \
        if K else 0
    tp_bound = int(off.max() if K else 0) + 2 * te0_max + 4
    assert (tp_bound + 2) * int(M) < int(_TP_INF), "key space overflow"
    F_thr = np.where(levels >= 0,
                     np.minimum(levels, tp_bound) * M + (M - 1),
                     np.int64(-1))
    batches: List[List[Tuple[int, int]]] = []
    starts: List[float] = []

    while active.any():
        # ---- clustering (Eqs. 15-18, offset-shifted) ---------------------
        # T^e: tasks completable in the remaining budget on dedicated
        # batches — int() truncation == floor for the (positive) budgets
        # of live services; inactive entries compute garbage that every
        # consumer below masks out through the key sentinel
        Te = (taup / step_cost).astype(np.int64)
        Tp = off2 + Tc + Te
        key = np.where(active, Tp * M + tie, _TP_INF)

        n_active = active.sum(axis=-1)
        F = key <= F_thr[:, None]
        n_F = F.sum(axis=-1)

        # ---- packing (Eqs. 19-20) ----------------------------------------
        te_max = np.max(np.where(F, Te, -1), axis=-1)
        tau_min = np.min(np.where(F, taup, np.inf), axis=-1)
        cap_f = np.floor((tau_min - b * te_max)
                         / (a * np.maximum(te_max, 1)))
        tp_min = key.min(axis=-1) >> shift       # min Tp over active
        cap_nf = np.floor((step_cost * tp_min - b_lv) / a_lv)
        x_f = np.where(te_max > 0,
                       np.maximum(n_F, np.minimum(n_active, cap_f)),
                       n_F)
        # no-priority-cluster branch: F empty forces min Tp > T*, so
        # cap >= 1 whenever the level >= 1; the explicit clamp states
        # that invariant at the site (mirrors stacking_pass — the
        # generic max(1, ...) below would absorb a negative cap
        # identically, but without the branch's reasoning)
        x_nf = np.minimum(n_active,
                          np.where(lv_pos, np.maximum(1, cap_nf),
                                   n_active))
        x_n = np.where(n_F > 0, x_f, x_nf)
        x_n = np.maximum(1, np.minimum(x_n, n_active))
        x_n = np.where(n_active > 0, x_n, 0).astype(np.int64)

        # ---- batching -----------------------------------------------------
        # the x_n cheapest (Tp, tau', id) services per row == every key
        # at or below the x_n-th smallest (keys are unique; x_n never
        # exceeds n_active and inactive keys sit at the sentinel, so the
        # selection is all-active by construction)
        sorted_key = np.sort(key, axis=-1)
        thr = np.take_along_axis(sorted_key,
                                 np.maximum(x_n - 1, 0)[:, None],
                                 axis=-1)[:, 0]
        thr = np.where(x_n > 0, thr, np.int64(-1))
        packed = key <= thr[:, None]
        n_packed = x_n.copy()
        while True:
            g = a * n_packed + b
            drop = packed & (taup + 1e-12 < g[:, None])
            if not drop.any():
                break
            packed &= ~drop                 # cannot afford this batch ->
            active &= ~drop                 # service is finished
            n_packed = packed.sum(axis=-1)

        has_batch = n_packed > 0
        g = a * n_packed + b
        if record and has_batch[0]:
            idx = np.flatnonzero(packed[0])
            members = idx[np.argsort(key[0, idx])]
            batches.append([(int(ids[j]), int(Tc[0, j]))
                            for j in members])
            starts.append(float(t[0]))
        if history is not None:
            history.append((key, packed, has_batch))
        np.add(t, g, out=t, where=has_batch)
        adv = active & has_batch[:, None]    # wall clock advances for all
        np.subtract(taup, g[:, None], out=taup, where=adv)     # (Eq. 15)
        Tc += packed
        # services that can no longer fit even a dedicated batch are done
        active &= taup + 1e-12 >= g1

    return Tc, t, batches, starts


def _lockstep_rounds(ids: np.ndarray, taup0: np.ndarray,
                     targets: np.ndarray, delay: DelayModel,
                     record: bool = False,
                     history: Optional[list] = None):
    """The lockstep sweep (``offset_pass`` / ``equal_steps`` inner
    loop), batched over per-row target vectors: every service still
    short of ``targets[l, k]`` additional steps joins every batch of
    row l, unaffordable members dropping out with the steps they have.

    Same return convention as ``_clustered_rounds``; recorded batches
    list members in service order, as the scalar loops do; ``history``
    collects ``(active, has_batch)`` snapshots for ``_replay_lockstep``.
    """
    a, b = delay.a, delay.b
    targets = np.asarray(targets, dtype=np.int64)
    L, K = targets.shape
    assert not record or L == 1, "batch recording needs a single target row"
    g1 = delay.min_task_delay()

    taup = np.tile(np.asarray(taup0, dtype=np.float64), (L, 1))
    Tc = np.zeros((L, K), dtype=np.int64)
    active = (targets > 0) & (taup0 >= g1)[None, :]
    t = np.zeros(L, dtype=np.float64)
    batches: List[List[Tuple[int, int]]] = []
    starts: List[float] = []

    while active.any():
        # drop members that cannot afford the current shared batch
        n = active.sum(axis=-1)
        while True:
            g = a * n + b
            drop = active & (taup + 1e-12 < g[:, None])
            if not drop.any():
                break
            active &= ~drop
            n = active.sum(axis=-1)
        has_batch = n > 0
        g = a * n + b
        if record and has_batch[0]:
            members = np.flatnonzero(active[0])
            batches.append([(int(ids[j]), int(Tc[0, j]))
                            for j in members])
            starts.append(float(t[0]))
        if history is not None:
            history.append((active.copy(), has_batch))
        np.add(t, g, out=t, where=has_batch)
        np.subtract(taup, g[:, None], out=taup, where=active)
        Tc += active
        active &= (Tc < targets) & (taup + 1e-12 >= g1)

    return Tc, t, batches, starts


def _replay_clustered(ids: np.ndarray, w: int, history: list,
                      delay: DelayModel):
    """Reconstruct row ``w``'s batch list from a clustered sweep's
    per-round snapshots — the same (batches, start_times) the scalar
    pass records, without re-running the pass."""
    a, b = delay.a, delay.b
    Tc = np.zeros(ids.size, dtype=np.int64)
    batches: List[List[Tuple[int, int]]] = []
    starts: List[float] = []
    t = 0.0
    for key, packed, has_batch in history:
        if not has_batch[w]:
            continue
        idx = np.flatnonzero(packed[w])
        members = idx[np.argsort(key[w, idx])]
        batches.append([(int(ids[j]), int(Tc[j])) for j in members])
        starts.append(t)
        t += a * len(members) + b
        Tc[packed[w]] += 1
    return batches, starts


def _replay_lockstep(ids: np.ndarray, w: int, history: list,
                     delay: DelayModel):
    """Reconstruct row ``w``'s batch list from a lockstep sweep's
    per-round snapshots (members in service order, as the scalar
    loops record)."""
    a, b = delay.a, delay.b
    Tc = np.zeros(ids.size, dtype=np.int64)
    batches: List[List[Tuple[int, int]]] = []
    starts: List[float] = []
    t = 0.0
    for active, has_batch in history:
        if not has_batch[w]:
            continue
        members = np.flatnonzero(active[w])
        batches.append([(int(ids[j]), int(Tc[j])) for j in members])
        starts.append(t)
        t += a * len(members) + b
        Tc[active[w]] += 1
    return batches, starts


def score_rows(rows: np.ndarray, quality) -> np.ndarray:
    """``quality.mean_fid`` of every row of a ``(L, K)`` count matrix,
    evaluated through the exact scalar call (vectorizing the quality
    model itself is off the table: SIMD ``pow`` differs from libm in
    the last ulp) but with duplicate rows — very common across
    neighbouring T* levels — scored once."""
    uniq, inverse = np.unique(np.asarray(rows), axis=0,
                              return_inverse=True)
    qs = np.empty(uniq.shape[0], dtype=np.float64)
    for u, counts in enumerate(uniq.tolist()):
        qs[u] = quality.mean_fid(counts)
    return qs[inverse.ravel()]


def first_best(rows: np.ndarray, quality) -> Tuple[int, float]:
    """The scalar outer searches' selection rule — the FIRST candidate
    strictly better (by 1e-12) than everything before it — over the
    rows of a ``(L, K)`` count matrix."""
    best_i, best_q = -1, float("inf")
    for i, q in enumerate(score_rows(rows, quality).tolist()):
        if q < best_q - 1e-12:
            best_i, best_q = i, q
    return best_i, best_q


# -------------------------------------------------------------------------
# Batched sweeps (scoring) and single-candidate passes (materialization)
# -------------------------------------------------------------------------

def sweep_clustered(arr: ServiceArrays, delay: DelayModel,
                    levels: Sequence[int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Completed counts + makespan of the Algorithm-1 pass for every
    candidate level at once: ``(Tc (L, K), makespan (L,))``.  Row l
    equals ``stacking_pass(..., t_star=levels[l], offsets=...)``'s
    ``steps_completed`` / ``makespan()`` exactly."""
    Tc, t, _, _ = _clustered_rounds(arr.ids, arr.tau_prime, arr.offsets,
                                    delay, np.asarray(levels))
    return Tc, t


def sweep_lockstep(arr: ServiceArrays, delay: DelayModel,
                   targets: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Completed counts + makespan of the lockstep pass for every
    target row at once (``targets`` is ``(L, K)`` *additional*-step
    targets aligned with ``arr`` rows)."""
    Tc, t, _, _ = _lockstep_rounds(arr.ids, arr.tau_prime,
                                   np.asarray(targets), delay)
    return Tc, t


def stacking_pass_vec(service_ids: Sequence[int],
                      tau_prime: Dict[int, float], delay: DelayModel,
                      t_star: int,
                      offsets: Optional[Dict[int, int]] = None
                      ) -> BatchPlan:
    """Drop-in vectorized ``stacking_pass``: one clustering-packing-
    batching sweep for a fixed T*, bit-identical to the scalar
    reference (same batches, same start times, same counts)."""
    arr = ServiceArrays.build(service_ids, tau_prime, offsets)
    Tc, _, batches, starts = _clustered_rounds(
        arr.ids, arr.tau_prime, arr.offsets, delay,
        np.asarray([t_star]), record=True)
    steps = {int(k): int(c) for k, c in zip(arr.ids, Tc[0])}
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=steps, delay=delay)


def offset_pass_vec(service_ids: Sequence[int],
                    tau_prime: Dict[int, float], delay: DelayModel,
                    targets: Dict[int, int]) -> BatchPlan:
    """Drop-in vectorized ``repro_torch.core.offset.offset_pass``: one
    lockstep sweep toward per-service additional-step targets."""
    arr = ServiceArrays.build(service_ids, tau_prime)
    tgt = np.asarray([[int(targets.get(int(k), 0)) for k in arr.ids]],
                     dtype=np.int64)
    Tc, _, batches, starts = _lockstep_rounds(arr.ids, arr.tau_prime,
                                              tgt, delay, record=True)
    steps = {int(k): int(c) for k, c in zip(arr.ids, Tc[0])}
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=steps, delay=delay)


def stacking_vec(services, tau_prime: Dict[int, float], delay: DelayModel,
                 quality, t_star_max: int = 0) -> BatchPlan:
    """Algorithm 1 with the outer T* search as one batched sweep: all
    candidate levels share the per-round ``Te``/``Tp`` tables and
    advance together, then the first strictly-best level (the scalar
    search's tie rule) is materialized as the returned plan."""
    ids = [s.id for s in services]
    if t_star_max <= 0:
        t_star_max = max(1, max(delay.max_steps(tau_prime[k])
                                for k in ids))
    arr = ServiceArrays.build(ids, tau_prime)
    levels = np.arange(1, t_star_max + 1, dtype=np.int64)
    hist: list = []
    Tc, _, _, _ = _clustered_rounds(arr.ids, arr.tau_prime, arr.offsets,
                                    delay, levels, history=hist)

    best_i, _ = first_best(Tc, quality)
    assert best_i >= 0
    batches, starts = _replay_clustered(arr.ids, best_i, hist, delay)
    steps = {int(k): int(c) for k, c in zip(arr.ids, Tc[best_i])}
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=steps, delay=delay)


def equal_steps_vec(services, tau_prime: Dict[int, float],
                    delay: DelayModel, quality) -> BatchPlan:
    """The balanced ``equal_steps`` baseline with its shared-target
    search as one batched lockstep sweep (row l targets T* = l + 1
    steps for every service), first strictly-best level materialized."""
    ids = [s.id for s in services]
    feasible = [k for k in ids if delay.max_steps(tau_prime[k]) > 0]
    t_max = max([delay.max_steps(tau_prime[k]) for k in feasible],
                default=1)
    arr = ServiceArrays.build(ids, tau_prime)
    levels = np.arange(1, max(1, t_max) + 1, dtype=np.int64)
    targets = np.broadcast_to(levels[:, None],
                              (levels.size, arr.K)).copy()
    hist: list = []
    Tc, _, _, _ = _lockstep_rounds(arr.ids, arr.tau_prime, targets,
                                   delay, history=hist)

    best_i, _ = first_best(Tc, quality)
    assert best_i >= 0
    batches, starts = _replay_lockstep(arr.ids, best_i, hist, delay)
    steps = {int(k): int(c) for k, c in zip(arr.ids, Tc[best_i])}
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=steps, delay=delay)


# The process default, validated last so an optional backend named by
# the env var can be probed (and can import this partially-initialized
# module) with every definition above already bound.  A typo'd env var
# still fails loudly, at import time, listing the registered engines.
_ENGINE = _require_engine(os.environ.get("REPRO_PLANNER_ENGINE", "vec"))
