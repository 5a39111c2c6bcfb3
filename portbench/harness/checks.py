"""The comparisons every cell makes of the planning and execution
layers, against the frozen copies (``harness/frozen.py``).

``plan_mismatch``: of a sample of the scheduler calls in the window,
drawn from the seed (first plans and replans apart), the number whose
allocation or batch plan differs from the frozen inv_se and STACKING
given the same inputs.  A replan is judged as the program makes it:
the residual requests, their tau' and the refit g(X) are the call's
inputs, and the steps each had already run (its offset) are counted
from the harness's own log of the session.  Exact: limit 0.

``exec_mismatch``: rounds whose executed batches are not the adopted
plans in order (each plan's batches up to the next replan, the last
one whole), whose retargets are not offsets plus the new plan's steps,
or whose loop records do not match the batches run.  Exact: limit 0.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from harness import frozen


def _offsets(log, n_batches: int, ids) -> List[int]:
    done: Dict[int, int] = {}
    for b_ids, _, _, _ in log.batches[:n_batches]:
        for k in b_ids:
            done[k] = done.get(k, 0) + 1
    return [done.get(k, 0) for k in ids]


def check_call(log, i: int, quality_cls, allocator: str) -> bool:
    """True where schedule call i of a round (and the allocation before
    it) equals the frozen copies' result on the same inputs."""
    sched = log.schedule_calls()[i]
    allocs = [c for c in log.calls if c.kind == "allocate"
              and c.t1 <= sched.t0]
    if allocs:
        a = allocs[-1]
        if allocator != "inv_se":
            raise ValueError(f"no frozen copy of allocator {allocator!r}")
        want = frozen.inv_se(a.inputs["eta"], a.inputs["total_hz"])
        if not np.array_equal(want, a.output):
            return False
    ids = sched.ids
    taup = sched.inputs["tau_prime"]
    if i == 0 and allocs:
        req = {q.id: q for q in log.requests}
        want = frozen.tau_prime(
            ids, [req[k].deadline for k in ids],
            [req[k].spectral_eff for k in ids], allocs[-1].output,
            log.content_bits)
        if want != taup:
            return False
    offsets = _offsets(log, sched.n_batches, ids)
    q = frozen.OffsetQuality(quality_cls(), offsets, ids, taup)
    batches, steps = frozen.stacking(
        ids, taup, frozen.Delay(sched.inputs["a"], sched.inputs["b"]), q)
    got_batches, got_steps = sched.output
    return ([[k for k, _ in b] for b in batches] == got_batches
            and {k: int(v) for k, v in steps.items()} == got_steps)


def plan_mismatch(rounds, rng: np.random.Generator, quality_cls,
                  allocator: str, n_first: int, n_replans: int) -> int:
    firsts = [(j, 0) for j, log in enumerate(rounds)
              if log.schedule_calls()]
    replans = [(j, i) for j, log in enumerate(rounds)
               for i in range(1, len(log.schedule_calls()))]
    picked = []
    for pool, n in ((firsts, n_first), (replans, n_replans)):
        if pool:
            sel = rng.choice(len(pool), size=min(n, len(pool)),
                             replace=False)
            picked += [pool[s] for s in sorted(sel)]
    return sum(not check_call(rounds[j], i, quality_cls, allocator)
               for j, i in picked)


def round_executed_as_planned(log) -> bool:
    calls = log.schedule_calls()
    segs, cur, totals = [], [], []
    for ev in log.events:
        if ev[0] == "batch":
            cur.append(list(ev[1]))
        else:
            segs.append(cur)
            totals.append(ev[1])
            cur = []
    segs.append(cur)
    if len(segs) != len(calls):
        return False
    for j, (seg, call) in enumerate(zip(segs, calls)):
        planned, steps = call.output
        if j == len(segs) - 1:
            if seg != planned:
                return False
        elif seg != planned[:len(seg)]:
            return False
        if j > 0:
            offs = _offsets(log, call.n_batches, call.ids)
            want = {k: o + steps.get(k, 0) for k, o in zip(call.ids, offs)}
            if totals[j - 1] != want:
                return False
    if len(log.records) != len(log.batches):
        return False
    return all(size == len(b[0])
               for (size, _, _), b in zip(log.records, log.batches))


def exec_mismatch(rounds) -> int:
    return sum(not round_executed_as_planned(log) for log in rounds)
