"""Array-native exact search: ``repro_torch.core.optimal``'s memoized
DP as a breadth-first sweep over integer state levels, each level's
expansion and scoring on the device — the counterpart of
``repro.core.jaxplan.optimal``.

With services pinned in tau'-ascending order, a state is the int64
steps vector, canonicalized by sorting steps within each equal-tau'
group (the scalar DP's sorted-tuple key); BFS depth == batch count, so
``np.unique`` over a level's states on the host IS the memoization.
Budgets shrink by the shared elapsed time ``a*S + b*n``, so the active
set is a suffix of the tau'-sorted order and "batch the m tightest
actives" is "+1 to the first m of that suffix", for every (state, m)
pair at once.  The optimum is the least stop-value over all reachable
states; parents are kept per level so the winning batch-size sequence
replays through the scalar member rule into an executable
``BatchPlan``.  The objective equals the scalar DP's within float
tolerance; among exactly tied optima the plan may differ.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.torchplan import kernels

F64 = torch.float64
_EPS = 1e-12      # same affordability slack as repro_torch.core.optimal


def _expand_core(states, valid, taus, group, fid_table, depth: int,
                 a: float, b: float):
    """One BFS level: stop-values of every state plus all (state, m)
    children in canonical form with their feasibility.  ``states (N, K)
    int64`` -> ``(stop_v (N,), children (N, K, K), feas (N, K))`` where
    children[i, m-1] batches the m tightest actives of state i."""
    N, K = states.shape
    dev = states.device
    g1 = a * 1 + b
    elapsed = a * states.sum(dim=-1).to(F64) + b * float(depth)
    active = taus[None, :] - elapsed[:, None] + _EPS >= g1
    n_active = active.sum(dim=-1)
    fa = active.to(torch.uint8).argmax(dim=-1)   # first index of the suffix
    tight = taus[fa]                            # tightest active budget

    ms = torch.arange(1, K + 1, dtype=torch.int64, device=dev)
    feas = (ms[None, :] <= n_active[:, None]) \
        & (tight[:, None] - elapsed[:, None] + _EPS
           >= a * ms[None, :].to(F64) + b) \
        & valid[:, None]

    j = torch.arange(K, dtype=torch.int64, device=dev)
    add = (j[None, None, :] >= fa[:, None, None]) \
        & (j[None, None, :] < fa[:, None, None] + ms[None, :, None])
    children = states[:, None, :] + add.to(torch.int64)

    # canonicalize: steps sorted within each equal-tau group (groups are
    # contiguous and position-ascending, so one keyed sort per row does it)
    big = fid_table.shape[0]
    children = torch.sort(group[None, None, :] * big + children,
                          dim=-1).values % big

    stop_v = torch.where(valid, fid_table[states].sum(dim=-1), torch.inf)
    return stop_v, children, feas


def _search(taus: np.ndarray, delay: DelayModel, quality: QualityModel,
            dev: torch.device
            ) -> Tuple[float, List[Tuple[np.ndarray, np.ndarray]], int, int]:
    """BFS over canonical states.  Returns (best stop-value, per-level
    (parent_idx, m) arrays, best depth, best index-at-depth)."""
    K = taus.size
    a, b = delay.a, delay.b
    g1 = delay.min_task_delay()
    if not g1 > 0:
        raise AssertionError("degenerate delay model: g(1) must be positive")
    # any service's step count is bounded: its s-th step cannot start
    # before (s-1) earlier batches ran, each costing >= g1 elapsed
    s_max = int(float(taus.max(initial=0.0)) / g1) + 4
    fid_table = np.array([quality.fid(s) for s in range(s_max + 1)],
                         dtype=np.float64)
    _, group = np.unique(taus, return_inverse=True)
    group = group.astype(np.int64).reshape(-1)
    taus_t, group_t, fid_t = kernels._on(dev, taus, group, fid_table)

    states = np.zeros((1, K), dtype=np.int64)
    parents: List[Tuple[np.ndarray, np.ndarray]] = []
    best_v, best_d, best_i = np.inf, 0, 0
    depth = 0
    while states.shape[0]:
        N = states.shape[0]
        Np = kernels._bucket(N)
        st_p = np.zeros((Np, K), dtype=np.int64)
        st_p[:N] = states
        valid = np.zeros(Np, dtype=bool)
        valid[:N] = True
        st_t, vd_t = kernels._on(dev, st_p, valid)
        stop_v, children, feas = _expand_core(st_t, vd_t, taus_t, group_t,
                                              fid_t, depth, a, b)
        stop_v = kernels._host(stop_v)
        i = int(np.argmin(stop_v))
        if stop_v[i] < best_v - _EPS:
            best_v, best_d, best_i = float(stop_v[i]), depth, i

        pidx, midx = np.nonzero(kernels._host(feas))
        if pidx.size == 0:
            break
        flat = kernels._host(children)[pidx, midx]
        states, first = np.unique(flat, axis=0, return_index=True)
        parents.append((pidx[first], midx[first] + 1))
        depth += 1
    return best_v, parents, best_d, best_i


def _batch_sizes(parents, depth: int, idx: int) -> List[int]:
    """Backtrack the winning state to the root, yielding the batch-size
    sequence that reaches it."""
    ms: List[int] = []
    while depth > 0:
        pidx, m = parents[depth - 1]
        ms.append(int(m[idx]))
        idx = int(pidx[idx])
        depth -= 1
    ms.reverse()
    return ms


def optimal_mean_fid(tau_prime: Sequence[float], delay: DelayModel,
                     quality: QualityModel, max_steps: int = 60,
                     grid: float = 1e-3) -> float:
    """Exact minimum mean FID, the BFS variant of
    ``repro_torch.core.optimal.optimal_mean_fid`` (same unused legacy
    args)."""
    taus = np.sort(np.asarray([float(t) for t in tau_prime],
                              dtype=np.float64))
    best_v, _, _, _ = _search(taus, delay, quality,
                              kernels.plan_device())
    return best_v / max(1, taus.size)


def optimal_plan(services, tau_prime: Dict[int, float], delay: DelayModel,
                 quality: QualityModel, *,
                 max_services: int = 8) -> BatchPlan:
    """Exact-search scheduler, the BFS variant of
    ``repro_torch.core.optimal.optimal_plan``: the same objective
    (within float tolerance) and the same member rule when replaying the
    winning batch-size sequence, so the plan passes
    ``validate(gen_deadlines=tau_prime)``."""
    ids = [s.id for s in services]
    K = len(ids)
    if K > max_services:        # the reference's error, also under -O
        raise AssertionError(
            f"optimal_plan is exact search; K={K} > {max_services}")
    taus = np.sort(np.asarray([float(tau_prime[k]) for k in ids],
                              dtype=np.float64))
    _, parents, best_d, best_i = _search(taus, delay, quality,
                                         kernels.plan_device())
    ms = _batch_sizes(parents, best_d, best_i)

    a, b = delay.a, delay.b
    g1 = delay.min_task_delay()
    Tc = {k: 0 for k in ids}
    batches, starts = [], []
    for n, m in enumerate(ms):
        elapsed = a * sum(Tc.values()) + b * n
        pairs = sorted((float(tau_prime[k]), Tc[k], k) for k in ids)
        members = [k for t, _, k in pairs
                   if t - elapsed + _EPS >= g1][:m]
        batches.append([(k, Tc[k]) for k in members])
        starts.append(elapsed)
        for k in members:
            Tc[k] += 1
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=Tc, delay=delay)
