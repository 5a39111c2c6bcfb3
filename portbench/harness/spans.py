"""The program's own spans (``repro_torch.obs``) in a traced run, for
the metric readers that read them.

The program records spans only while a profiler runs, so in a run they
are the traced rounds' (``Tracer.start`` opens one).  They share the
host clock ``time.perf_counter()`` with the tracer's device operations
and idle gaps.  Each reader takes the spans that lie inside the traced
window (``tracer.t0``-``tracer.t1``) and returns ``None`` without a
tracer, or where the program records no spans.

Idle time by layer: each idle gap of the device is split by intersecting
it with the spans' self intervals (a span's interval less its
children's), so each part of a gap goes to the innermost program span
the host was in during that part, not to the span open when the gap
began.  What no program span covers is the harness's own.
"""

from __future__ import annotations

from typing import Dict, List, Optional

LAYERS = {"allocate": "planner", "plan": "planner", "validate": "planner",
          "loop.replan": "planner",
          "round": "loop", "simulate": "loop", "execute": "loop",
          "loop.batch": "loop",
          "session.open": "engine", "session.finish": "engine"}


def layer(name: str) -> str:
    """The layer a span's self time belongs to: ``planner``, ``loop``,
    ``engine`` (the diffusion engine), ``serving`` or ``other``."""
    if name in LAYERS:
        return LAYERS[name]
    head = name.split(".", 1)[0]
    return head if head in ("engine", "serving") else "other"


def program_spans(ctx) -> Optional[tuple]:
    """(every span the program recorded, the indices of those inside the
    traced window), or None: no tracer, or a program without spans."""
    t = ctx.tracer
    if t is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.spans()
    inside = [i for i, s in enumerate(spans)
              if s.t1 is not None and t.t0 <= s.t0 and s.t1 <= t.t1]
    return spans, inside


def window_spans(ctx, name: str) -> Optional[list]:
    """The spans named ``name`` inside the traced window, or None."""
    got = program_spans(ctx)
    if got is None:
        return None
    spans, inside = got
    return [spans[i] for i in inside if spans[i].name == name]


def self_intervals(spans: List, inside: List[int]) -> List[tuple]:
    """(start, end, layer) of each span's own time, its children's
    intervals taken out, sorted by start."""
    kids: Dict[int, list] = {}
    for s in spans:
        if s.parent >= 0 and s.t1 is not None:
            kids.setdefault(s.parent, []).append((s.t0, s.t1))
    out = []
    for i in inside:
        s = spans[i]
        cur, lay = s.t0, layer(s.name)
        for c0, c1 in sorted(kids.get(i, ())):
            if c0 > cur:
                out.append((cur, c0, lay))
            cur = max(cur, c1)
        if s.t1 > cur:
            out.append((cur, s.t1, lay))
    out.sort()
    return out


def idle_pct_by_layer(ctx) -> Optional[Dict[str, float]]:
    """Percent of the traced window in which the device was idle while
    the host was in each layer's own time, and ``harness`` where no
    program span was open; they sum to ``device_idle_pct``."""
    got = program_spans(ctx)
    t = ctx.tracer
    if got is None or t.window_s <= 0:
        return None
    pieces = self_intervals(*got)
    out = dict.fromkeys(("planner", "engine", "loop", "serving", "other"),
                        0.0)
    idle = 0.0
    j = 0
    for g0, d in sorted(t.gaps):
        g1 = g0 + d
        idle += d
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            p0, p1, lay = pieces[k]
            out[lay] += max(0.0, min(g1, p1) - max(g0, p0))
            k += 1
    out["harness"] = idle - sum(out.values())
    return {k: 100.0 * v / t.window_s for k, v in out.items()}
