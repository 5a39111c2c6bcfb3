"""Spans of the program's layers, recorded only while a profiler runs.

    from repro_torch import obs
    with obs.span("plan"):
        ...
    with obs.span("loop.batch", size=len(ks)) as sp:
        dt = session.run_batch(ks, timed=True)
        sp.set(measured_s=dt)

A span is recorded only while a ``torch.profiler`` session is active in
the process (``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile`` sets on entering, whatever its activities).
So a traced benchmark round, or an operator profiling a server, records
spans, and every other run pays one flag check a span and gets a shared
no-op context.

Each span holds its name, its start and end on ``time.perf_counter()``
(the host clock a device trace is mapped onto through marker kernels,
so spans and device operations share one clock), the index of its
parent span, the round it belongs to (the index of the outermost
``round`` span above it, ``-1`` outside any round) and a few scalar
attributes.  Spans stay in memory in the order they open, a span's
index its position: ``spans()`` reads them, ``take()`` reads and clears
them.  Nothing is written to a file.  Spans nest per thread.
"""

from __future__ import annotations

import threading
import time
from typing import List

import torch.autograd.profiler as _profiler

_SPANS: List["Span"] = []
_LOCK = threading.Lock()            # a span's index is its position
_open = threading.local()           # .stack: indices of the open spans


class Span:
    """One recorded interval; a context manager while it is open."""

    __slots__ = ("name", "t0", "t1", "parent", "round", "attrs")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.t0 = self.t1 = None
        self.parent = self.round = -1

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _open(self) -> None:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        if stack:
            self.parent = stack[-1]
            self.round = _SPANS[self.parent].round
        with _LOCK:
            index = len(_SPANS)
            _SPANS.append(self)
        if self.round < 0 and self.name == "round":
            self.round = index
        stack.append(index)

    def __enter__(self) -> "Span":
        self._open()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter()
        _open.stack.pop()
        return False


class _Off:
    """The context every span returns while no profiler runs."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A span named ``name`` over the ``with`` block, with ``attrs``;
    a shared no-op context when no profiler is active."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """A span already timed by the caller's own ``perf_counter`` pair,
    under the span open now."""
    if _profiler._is_profiler_enabled:
        s = Span(name, attrs)
        s._open()
        s.t0, s.t1 = t0, t1
        _open.stack.pop()


def spans() -> List[Span]:
    """Every span recorded so far (a span's index is its position)."""
    return list(_SPANS)


def take() -> List[Span]:
    """The recorded spans, which are then cleared.  Call it with no span
    open: an open span's index would point into the cleared list."""
    with _LOCK:
        out = list(_SPANS)
        _SPANS.clear()
    return out
