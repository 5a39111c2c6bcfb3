"""The device trace of a traced run: ``torch.profiler`` with CUDA
activity only (no host op is recorded, so the host path runs at its
own speed), bracketed by two marker kernels that tie the device's clock
to the host's.

Read from it: every device operation (kernel, copy, set) with its
name and interval, the device's busy seconds (the union of those
intervals) inside the traced window, the window's length, and the idle
gaps, each named by the harness span the host was in when it opened
(``plan``, ``batch``, ``round``: inside a round between calls,
``between``: between rounds).
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel
MARKER_CYCLES = 1000


class Tracer:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        self.ops: List[Tuple[str, float, float]] = []   # name, start, dur
        self.busy_s = self.window_s = 0.0
        self.gaps: List[Tuple[float, float]] = []        # host start, dur

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self._read()
        self.prof = None

    def _read(self) -> None:
        from torch.autograd import DeviceType
        evs = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        evs.sort(key=lambda e: e[1])
        marks = [e for e in evs if MARKER in e[0]]
        if len(marks) >= 2:
            lo, hi = marks[0][1] + marks[0][2], marks[-1][1]
            zero_ns, zero_host = marks[0][1], self.t0
        else:               # no markers: the outermost operations
            lo = evs[0][1] if evs else 0
            hi = max((s + d for _, s, d in evs), default=lo)
            zero_ns, zero_host = lo, self.t0
        ops = [(n, s, d) for n, s, d in evs
               if MARKER not in n and s >= lo and s + d <= hi]
        self.ops = [(n, (s - zero_ns) * 1e-9 + zero_host, d * 1e-9)
                    for n, s, d in ops]
        self.window_s = (hi - lo) * 1e-9
        busy, cur_s, cur_e, gaps = 0, None, None, []
        prev_end = lo
        for _, s, d in ops:
            e = s + d
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                if s > prev_end:
                    gaps.append((prev_end, s - prev_end))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            prev_end = max(prev_end, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        if hi > prev_end:
            gaps.append((prev_end, hi - prev_end))
        self.busy_s = busy * 1e-9
        self.gaps = [((s - zero_ns) * 1e-9 + zero_host, d * 1e-9)
                     for s, d in gaps]

    def kernel_seconds(self, *names: str) -> Tuple[float, int]:
        """Device seconds and launches of the operations whose name
        holds any of ``names``."""
        hit = [d for n, _, d in self.ops if any(x in n for x in names)]
        return float(sum(hit)), len(hit)

    def breakdown(self, spans: List[Tuple[str, float, float]]) -> dict:
        """The ten operations that took most device time, and the idle
        time summed by the host span open when each gap began."""
        by_op: Dict[str, float] = {}
        for n, _, d in self.ops:
            key = n if len(n) <= 160 else n[:157] + "..."
            by_op[key] = by_op.get(key, 0.0) + d
        idle: Dict[str, float] = {}
        for t, d in self.gaps:
            name = "between"
            for sname, s0, s1 in spans:
                if s0 <= t < s1:
                    name = sname
                    if sname != "round":
                        break
            idle[name] = idle.get(name, 0.0) + d
        top = lambda m: [[k, v] for k, v in                 # noqa: E731
                         sorted(m.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(by_op), "idle_gaps": top(idle)}
