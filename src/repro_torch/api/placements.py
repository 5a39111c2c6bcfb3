"""Multi-server assignment strategies, named in ``PLACEMENTS``.

A placement has the uniform signature

    (scenario, scheduler, allocator, delay, quality, **kwargs)
        -> np.ndarray of server indices (one per service)

mirroring the Allocator protocol one level up: it decides *which cell*
hosts each service, and delegates the within-cell bandwidth split to
the given allocator (the per-cell P1).  All strategies respect
``EdgeServer.capacity`` and are deterministic.

  * ``round_robin``   — service i -> server i mod M (scenario order);
                        the obvious baseline, blind to speeds/deadlines.
  * ``least_loaded``  — scenario order, each service to the cell with
                        the least speed-normalized load.
  * ``greedy_fid``    — marginal-gain: tightest-deadline services
                        first, each to the cell whose summed FID (via a
                        real per-cell allocate -> plan evaluation)
                        increases the least.
  * ``alternating``   — coordinate descent alternating placement moves
                        with per-cell bandwidth refinement by the
                        existing ``coordinate`` allocator.

The port of ``repro.api.placements``: the reference's registry is the
plain dict ``PLACEMENTS`` here, with its aliases (``rr``,
``coord_desc``).  Too little capacity raises ``ValueError`` where the
reference asserts.  tests/test_torch_multiserver.py holds every
assignment ``==`` to the reference's.
"""

from __future__ import annotations

import functools
from typing import Dict, FrozenSet, List, Tuple

import numpy as np

from repro_torch.api.provisioner import ALLOCATORS
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.multiserver import cell_objective
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import Scenario


def _capacities_ok(scn: Scenario) -> None:
    caps = [s.capacity for s in scn.server_list]
    room = sum(c if c is not None else scn.K for c in caps)
    if room < scn.K:
        raise ValueError(f"server capacities admit {room} < K={scn.K} "
                         f"services")


def _eligible(counts: List[int], scn: Scenario) -> List[int]:
    return [m for m, sv in enumerate(scn.server_list)
            if sv.has_room(counts[m])]


def round_robin(scn: Scenario, scheduler=None, allocator=None,
                delay: DelayModel = None, quality: QualityModel = None,
                **_) -> np.ndarray:
    """Service i -> server i mod M in scenario order, skipping full
    cells.  Ignores speeds and deadlines entirely — the baseline every
    smarter placement must beat."""
    _capacities_ok(scn)
    M = scn.n_servers
    counts = [0] * M
    out = np.zeros(scn.K, dtype=int)
    nxt = 0
    for i in range(scn.K):
        for probe in range(M):
            m = (nxt + probe) % M
            if scn.server_list[m].has_room(counts[m]):
                out[i] = m
                counts[m] += 1
                nxt = (m + 1) % M
                break
    return out


def least_loaded(scn: Scenario, scheduler=None, allocator=None,
                 delay: DelayModel = None, quality: QualityModel = None,
                 **_) -> np.ndarray:
    """Scenario order; each service to the cell with the least
    speed-normalized load (hosted services / speed), ties by id.  A fast
    speed-aware heuristic needing no inner planning."""
    _capacities_ok(scn)
    servers = scn.server_list
    counts = [0] * len(servers)
    out = np.zeros(scn.K, dtype=int)
    for i in range(scn.K):
        m = min(_eligible(counts, scn),
                key=lambda j: (counts[j] / servers[j].speed, j))
        out[i] = m
        counts[m] += 1
    return out


class _CellCache:
    """Memoized per-cell objective: (server, member-id set) -> summed FID
    via the cell's own allocate -> plan pipeline."""

    def __init__(self, scn: Scenario, scheduler, allocator,
                 delay: DelayModel, quality: QualityModel):
        self.scn = scn
        self.scheduler = scheduler
        self.allocator = allocator
        self.delay = delay
        self.quality = quality
        self._memo: Dict[Tuple[int, FrozenSet[int]], float] = {}

    def sub_scenario(self, m: int, ids: FrozenSet[int]) -> Scenario:
        server = self.scn.server_list[m]
        members = [s for s in self.scn.services if s.id in ids]
        return Scenario(services=members,
                        total_bandwidth_hz=server.bandwidth_hz,
                        content_bits=self.scn.content_bits)

    def objective(self, m: int, ids: FrozenSet[int]) -> float:
        key = (m, ids)
        if key not in self._memo:
            server = self.scn.server_list[m]
            self._memo[key] = cell_objective(
                self.sub_scenario(m, ids), self.scheduler, self.allocator,
                server.delay_model(self.delay), self.quality)
        return self._memo[key]


def greedy_fid(scn: Scenario, scheduler=None, allocator=None,
               delay: DelayModel = None, quality: QualityModel = None,
               **_) -> np.ndarray:
    """Marginal-gain assignment: services in tightest-deadline-first
    order; each goes to the cell whose summed FID — evaluated by
    actually allocating and planning the cell — rises the least."""
    _capacities_ok(scn)
    delay = delay if delay is not None else DelayModel()
    cache = _CellCache(scn, scheduler, allocator, delay, quality)
    servers = scn.server_list
    members: List[FrozenSet[int]] = [frozenset() for _ in servers]
    obj = [0.0] * len(servers)
    out = np.zeros(scn.K, dtype=int)
    order = sorted(range(scn.K),
                   key=lambda i: (scn.services[i].deadline,
                                  scn.services[i].id))
    for i in order:
        svc = scn.services[i]
        counts = [len(ms) for ms in members]
        best_m, best_delta = None, None
        for m in _eligible(counts, scn):
            trial = members[m] | {svc.id}
            delta = cache.objective(m, trial) - obj[m]
            if best_delta is None or delta < best_delta - 1e-12:
                best_m, best_delta = m, delta
        members[best_m] = members[best_m] | {svc.id}
        obj[best_m] = cache.objective(best_m, members[best_m])
        out[i] = best_m
    return out


def alternating(scn: Scenario, scheduler=None, allocator=None,
                delay: DelayModel = None, quality: QualityModel = None,
                *, init: str = "least_loaded", sweeps: int = 2,
                inner_rounds: int = 1, **_) -> np.ndarray:
    """Placement <-> bandwidth coordinate descent.

    Starts from ``init`` (any ``PLACEMENTS`` name), then alternates:
    the bandwidth coordinate is re-optimized per cell by the existing
    ``coordinate`` allocator (pairwise-transfer hill climb with
    ``inner_rounds`` sweeps), and the placement coordinate tries moving
    each service to every other cell, keeping moves that lower the
    system objective under those refined per-cell allocations.  Stops
    after ``sweeps`` full passes or at the first pass with no move.

    Because moves are scored under coordinate-refined per-cell
    allocations, pair this placement with ``allocator="coordinate"``
    so the provisioner realizes the same bandwidth the descent
    optimized (the benchmark suite does); under a different allocator
    only the assignment carries over and an accepted move is not
    guaranteed to help.
    """
    _capacities_ok(scn)
    delay = delay if delay is not None else DelayModel()
    assign = np.asarray(PLACEMENTS[init](
        scn, scheduler, allocator, delay, quality)).copy()
    refine = functools.partial(ALLOCATORS["coordinate"],
                               rounds=inner_rounds)
    cache = _CellCache(scn, scheduler, refine, delay, quality)
    servers = scn.server_list
    M = len(servers)
    members = [frozenset(s.id for s, a in zip(scn.services, assign)
                         if a == m) for m in range(M)]
    obj = [cache.objective(m, members[m]) for m in range(M)]
    for _ in range(sweeps):
        moved = False
        for i in range(scn.K):
            svc = scn.services[i]
            src = int(assign[i])
            best = None            # (delta, dst, new_src_obj, new_dst_obj)
            for dst in range(M):
                if dst == src or \
                        not servers[dst].has_room(len(members[dst])):
                    continue
                new_src = cache.objective(src, members[src] - {svc.id})
                new_dst = cache.objective(dst, members[dst] | {svc.id})
                delta = (new_src + new_dst) - (obj[src] + obj[dst])
                if delta < -1e-9 and (best is None or delta < best[0]):
                    best = (delta, dst, new_src, new_dst)
            if best is not None:
                _, dst, new_src, new_dst = best
                members[src] = members[src] - {svc.id}
                members[dst] = members[dst] | {svc.id}
                obj[src], obj[dst] = new_src, new_dst
                assign[i] = dst
                moved = True
        if not moved:
            break
    return assign


#: placement name -> callable; aliases map to the same object
PLACEMENTS = {"round_robin": round_robin, "rr": round_robin,
              "least_loaded": least_loaded, "greedy_fid": greedy_fid,
              "alternating": alternating, "coord_desc": alternating}
