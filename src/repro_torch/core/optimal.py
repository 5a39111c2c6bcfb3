"""Exact reference solver for tiny instances (beyond-paper §Beyond):
exhaustive search over batch-size sequences to measure STACKING's
optimality gap on problem (P2).

Because the delay model is affine (g(X) = aX + b), the elapsed time of
any schedule prefix is *exactly* a*S + b*N where S = tasks scheduled so
far and N = batches so far — both integers.  The DP therefore needs no
time discretization: feasibility checks are exact, and the same
memoized recursion backs both ``optimal_mean_fid`` (the scalar bound)
and ``optimal_plan`` (the registry's ``"optimal"`` scheduler, which
reconstructs an executable ``BatchPlan`` from the DP's decisions).

At each decision point the server batches the m tightest-budget active
services (batching any other subset of the same size is dominated,
because step counts enter quality symmetrically and budgets only
shrink).  Memoized over (batch count, sorted (deadline, steps) pairs);
exponential worst case, only used with small K.  A copy of
``repro.core.optimal``; ``engine="torch"`` runs the breadth-first sweep
of ``repro_torch.core.torchplan.optimal``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core import arrays
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.plan import BatchPlan
from repro_torch.core.quality_model import QualityModel

# affordability slack, matching the schedulers' float convention
# (see stacking.py: ``taup[k] + 1e-12 < g`` means "cannot afford")
_EPS = 1e-12


def _make_dp(delay: DelayModel, quality: QualityModel):
    """Exact memoized DP.  ``best(n_batches, state)`` returns
    (minimum total FID reachable, best next batch size m; m=0 = stop),
    where state is a sorted tuple of (tau_prime, steps_done) pairs."""
    a, b = delay.a, delay.b
    g1 = delay.min_task_delay()
    assert g1 > 0, "degenerate delay model: g(1) must be positive"

    @functools.lru_cache(maxsize=2_000_000)
    def best(n_batches: int,
             state: Tuple[Tuple[float, int], ...]) -> Tuple[float, int]:
        elapsed = a * sum(s for _, s in state) + b * n_batches
        stop_v = sum(quality.fid(s) for _, s in state)
        # active = can still afford a dedicated batch; budgets shrink with
        # the common elapsed time, so "tightest" = smallest tau_prime
        active = sorted((t, s) for t, s in state
                        if t - elapsed + _EPS >= g1)
        if not active:
            return stop_v, 0
        inactive = [x for x in state if x[0] - elapsed + _EPS < g1]
        best_v, best_m = stop_v, 0
        for m in range(1, len(active) + 1):
            if active[0][0] - elapsed + _EPS < delay.g(m):
                break          # the tightest member cannot afford this
                               # batch; larger batches only cost more
            nxt = [(t, s + 1 if i < m else s)
                   for i, (t, s) in enumerate(active)]
            v, _ = best(n_batches + 1, tuple(sorted(nxt + inactive)))
            if v < best_v - _EPS:
                best_v, best_m = v, m
        return best_v, best_m

    return best


def optimal_mean_fid(tau_prime: Sequence[float], delay: DelayModel,
                     quality: QualityModel, max_steps: int = 60,
                     grid: float = 1e-3,
                     engine: Optional[str] = None) -> float:
    """Exact minimum mean FID over all batch schedules (small K only).

    ``max_steps``/``grid`` are retained for call-site compatibility but
    unused: the affine delay model makes the DP exact without either.
    ``engine`` follows the planner-engine convention: ``None``/``vec``/
    ``scalar`` run this module's memoized DP; a registered backend
    (e.g. ``"torch"``) runs its own exact search, equal within float
    tolerance.
    """
    impl = arrays.engine_impl(arrays.resolve_engine(engine))
    if impl is not None:
        return impl.optimal_mean_fid(tau_prime, delay, quality,
                                     max_steps, grid)
    K = len(tau_prime)
    best = _make_dp(delay, quality)
    v, _ = best(0, tuple(sorted((float(t), 0) for t in tau_prime)))
    return v / K


def optimal_plan(services, tau_prime: Dict[int, float], delay: DelayModel,
                 quality: QualityModel, *,
                 max_services: int = 8,
                 engine: Optional[str] = None) -> BatchPlan:
    """Exact-search *scheduler*: reconstructs an executable ``BatchPlan``
    from the DP's decisions.  Its mean FID equals ``optimal_mean_fid``
    and the plan passes ``BatchPlan.validate(gen_deadlines=tau_prime)``.
    Exponential worst case — refuses K > ``max_services``.  ``engine``
    as in ``optimal_mean_fid`` (registered backends run their own exact
    search; among exactly tied optima the plans may differ).
    """
    impl = arrays.engine_impl(arrays.resolve_engine(engine))
    if impl is not None:
        return impl.optimal_plan(services, tau_prime, delay, quality,
                                 max_services=max_services)
    ids = [s.id for s in services]
    K = len(ids)
    if K > max_services:        # the reference's error, also under -O
        raise AssertionError(
            f"optimal_plan is exact search; K={K} > {max_services}")
    best = _make_dp(delay, quality)
    g1 = delay.min_task_delay()
    a, b = delay.a, delay.b

    Tc = {k: 0 for k in ids}
    batches, starts = [], []
    n_batches = 0
    while True:
        elapsed = a * sum(Tc.values()) + b * n_batches
        pairs = sorted((float(tau_prime[k]), Tc[k], k) for k in ids)
        _, m = best(n_batches, tuple((t, s) for t, s, _ in pairs))
        if m == 0:
            break
        members = [k for t, _, k in pairs
                   if t - elapsed + _EPS >= g1][:m]
        batches.append([(k, Tc[k]) for k in members])
        starts.append(elapsed)
        for k in members:
            Tc[k] += 1
        n_batches += 1
    return BatchPlan(batches=batches, start_times=starts,
                     steps_completed=Tc, delay=delay)
