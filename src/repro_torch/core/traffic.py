"""Arrival processes for population-scale fleet simulation.

The paper evaluates provisioning at tens of services with arrivals
listed by hand; a fleet of cells serving millions of users needs the
arrivals *generated* — and the interesting provisioning regimes are
exactly the non-homogeneous ones (diurnal load curves, flash crowds,
cells whose load moves together).  This module supplies those as small
stateless samplers with one shared contract:

``process.sample(rng, t0, t1) -> float64 array``
    strictly-sorted arrival times in the half-open window
    ``[t0, t1)``.  Samplers hold no mutable state; all randomness
    comes from the ``numpy.random.Generator`` handed in, so a fleet
    run is reproducible from its seed and each cell can own an
    independent stream (``np.random.default_rng([seed, cell])`` is the
    fleet convention).

Random processes are sampled *per window*: calling ``sample`` over
``[0, 10)`` and over ``[0, 5) + [5, 10)`` draws different (equally
distributed) realizations because the generator state advances
differently.  ``TraceArrivals`` is the exception — a trace is a fixed
set of timestamps, so its windows are exact set-partitions of the
trace and any chunking reproduces the same arrivals.  The fleet
harness leans on this to prove its event and epoch modes equivalent.

A NumPy copy of ``repro.core.traffic`` (tests/test_torch_traffic.py
holds every sample ``==`` to the original's).  Processes are named in
``repro_torch.api.fleet.ARRIVALS``.
"""

from __future__ import annotations

import csv
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Sequence, Union

import numpy as np

__all__ = [
    "ArrivalProcess",
    "PoissonProcess",
    "InhomogeneousPoisson",
    "DiurnalPoisson",
    "FlashCrowd",
    "TraceArrivals",
    "load_trace",
    "correlated_rates",
]


class ArrivalProcess:
    """Protocol: anything with ``sample(rng, t0, t1) -> sorted float64
    times in [t0, t1)``.  The classes below are the stock processes;
    user code can register anything satisfying this shape."""

    def sample(self, rng: np.random.Generator, t0: float,
               t1: float) -> np.ndarray:  # pragma: no cover - protocol
        raise NotImplementedError

    def mean_rate(self, t0: float, t1: float) -> float:
        """Expected arrivals per unit time over the window — used for
        sizing (epoch widths, benchmark budgets), not sampling."""
        raise NotImplementedError  # pragma: no cover - protocol


def _check_window(t0: float, t1: float) -> float:
    if not (math.isfinite(t0) and math.isfinite(t1)) or t1 < t0:
        raise ValueError(f"arrival window [{t0}, {t1}) is not a finite "
                         f"forward interval")
    return t1 - t0


@dataclass(frozen=True)
class PoissonProcess(ArrivalProcess):
    """Homogeneous Poisson arrivals at ``rate`` per unit time.

    Sampled the standard conditional-uniform way: the window count is
    one Poisson draw, the times are that many sorted uniforms — O(n)
    per window with no sequential exponential loop.
    """

    rate: float

    def __post_init__(self):
        if not (self.rate >= 0.0 and math.isfinite(self.rate)):
            raise ValueError(f"rate must be finite and >= 0, got "
                             f"{self.rate}")

    def sample(self, rng: np.random.Generator, t0: float,
               t1: float) -> np.ndarray:
        span = _check_window(t0, t1)
        n = rng.poisson(self.rate * span)
        return np.sort(t0 + span * rng.random(n))

    def mean_rate(self, t0: float, t1: float) -> float:
        _check_window(t0, t1)
        return self.rate


@dataclass(frozen=True)
class InhomogeneousPoisson(ArrivalProcess):
    """Poisson arrivals with a time-varying intensity ``rate_fn(t)``,
    sampled by thinning (Lewis & Shedler): draw homogeneous candidates
    at the envelope ``rate_max``, keep each with probability
    ``rate_fn(t) / rate_max``.  Exact for any intensity bounded by the
    envelope; a ``rate_fn`` exceeding it raises rather than silently
    under-sampling.
    """

    rate_fn: Callable[[np.ndarray], np.ndarray]
    rate_max: float

    def __post_init__(self):
        if not (self.rate_max > 0.0 and math.isfinite(self.rate_max)):
            raise ValueError(f"rate_max must be finite and > 0, got "
                             f"{self.rate_max}")

    def sample(self, rng: np.random.Generator, t0: float,
               t1: float) -> np.ndarray:
        span = _check_window(t0, t1)
        n = rng.poisson(self.rate_max * span)
        cand = np.sort(t0 + span * rng.random(n))
        rates = np.asarray(self.rate_fn(cand), dtype=np.float64)
        rates = np.broadcast_to(rates, cand.shape)
        if rates.size and (rates.max(initial=0.0) > self.rate_max
                           * (1 + 1e-12) or rates.min(initial=0.0) < 0):
            raise ValueError(
                f"rate_fn left [0, rate_max={self.rate_max}] on "
                f"[{t0}, {t1}); thinning would mis-sample — raise the "
                f"envelope")
        return cand[rng.random(cand.shape) * self.rate_max < rates]

    def mean_rate(self, t0: float, t1: float) -> float:
        span = _check_window(t0, t1)
        if span == 0.0:
            return 0.0
        # trapezoid over a fixed grid — sizing only, not sampling
        ts = np.linspace(t0, t1, 129)
        vals = np.broadcast_to(
            np.asarray(self.rate_fn(ts), dtype=np.float64), ts.shape)
        trapezoid = getattr(np, "trapezoid", None) or np.trapz
        return float(trapezoid(vals, ts) / span)


def DiurnalPoisson(base_rate: float, amplitude: float = 0.5,
                   period: float = 24.0,
                   phase: float = 0.0) -> InhomogeneousPoisson:
    """A diurnal load curve: intensity
    ``base_rate * (1 + amplitude * sin(2*pi*(t - phase) / period))``.

    ``amplitude`` in [0, 1] keeps the intensity nonnegative (1.0 means
    the trough hits zero — a fully off-peak quiet hour).
    """
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    if not (base_rate >= 0.0 and math.isfinite(base_rate)):
        raise ValueError(f"base_rate must be finite and >= 0, got "
                         f"{base_rate}")
    if not (period > 0.0 and math.isfinite(period)):
        raise ValueError(f"period must be finite and > 0, got {period}")
    w = 2.0 * math.pi / period

    def rate_fn(t):
        return base_rate * (1.0 + amplitude * np.sin(w * (np.asarray(t)
                                                          - phase)))

    return InhomogeneousPoisson(
        rate_fn=rate_fn, rate_max=base_rate * (1.0 + amplitude)
        if base_rate > 0 else 1e-12)


def FlashCrowd(base_rate: float, peak_rate: float, start: float,
               duration: float) -> InhomogeneousPoisson:
    """A flash crowd: baseline Poisson load that jumps to ``peak_rate``
    on ``[start, start + duration)`` and snaps back — the arrival shape
    that stresses admission and batching the hardest (a whole window of
    deadlines lands on one cell at once)."""
    if peak_rate < base_rate:
        raise ValueError(f"peak_rate {peak_rate} < base_rate "
                         f"{base_rate}; a flash crowd is a surge")
    if not (base_rate >= 0.0 and math.isfinite(peak_rate)):
        raise ValueError("rates must be finite and >= 0")
    if duration < 0.0:
        raise ValueError(f"duration must be >= 0, got {duration}")
    end = start + duration

    def rate_fn(t):
        t = np.asarray(t)
        return np.where((t >= start) & (t < end), peak_rate, base_rate)

    return InhomogeneousPoisson(rate_fn=rate_fn,
                                rate_max=max(peak_rate, 1e-12))


@dataclass(frozen=True)
class TraceArrivals(ArrivalProcess):
    """Replay a fixed list of arrival timestamps.

    Deterministic and *chunk-independent*: sampling ``[t0, t1)`` simply
    slices the sorted trace, so any partition of a horizon reproduces
    exactly the same arrivals — the property the fleet harness uses to
    cross-check its event and epoch modes against each other.
    """

    times: np.ndarray = field()

    def __init__(self, times: Sequence[float]):
        arr = np.asarray(list(times), dtype=np.float64)
        if arr.ndim != 1:
            raise ValueError(f"trace must be a flat list of timestamps, "
                             f"got shape {arr.shape}")
        if arr.size and not np.isfinite(arr).all():
            raise ValueError("trace contains non-finite timestamps")
        object.__setattr__(self, "times", np.sort(arr))

    def sample(self, rng: np.random.Generator, t0: float,
               t1: float) -> np.ndarray:
        _check_window(t0, t1)
        lo = np.searchsorted(self.times, t0, side="left")
        hi = np.searchsorted(self.times, t1, side="left")
        return self.times[lo:hi].copy()

    def mean_rate(self, t0: float, t1: float) -> float:
        span = _check_window(t0, t1)
        if span == 0.0:
            return 0.0
        return float(self.sample(np.random.default_rng(0), t0,
                                 t1).size / span)


def _trace_time(raw, where: str) -> float:
    try:
        t = float(raw)
    except (TypeError, ValueError):
        raise ValueError(f"{where}: arrival time {raw!r} is not a "
                         f"number") from None
    if not math.isfinite(t) or t < 0.0:
        raise ValueError(f"{where}: arrival time {t!r} must be finite "
                         f"and >= 0")
    return t


def load_trace(path: Union[str, Path], cell: int = 0) -> TraceArrivals:
    """Load one cell's arrival trace from a CSV or JSON file.

    CSV schema: header ``cell,arrival`` (extra columns ignored), one
    row per arrival.  JSON schema: either a flat list of timestamps
    (single-cell traces) or ``{"<cell>": [t, ...], ...}`` keyed by cell
    index.  Malformed rows — missing columns, non-numeric or negative
    times, unknown structure — raise ``ValueError`` naming the file,
    the row, and what was wrong; a loader that silently drops rows
    would corrupt load shapes undetectably.
    """
    p = Path(path)
    if p.suffix.lower() == ".json":
        try:
            doc = json.loads(p.read_text())
        except json.JSONDecodeError as e:
            raise ValueError(f"{p}: not valid JSON ({e})") from None
        if isinstance(doc, list):
            if cell != 0:
                raise ValueError(f"{p}: flat JSON trace has no per-cell "
                                 f"keys but cell={cell} was requested")
            times = [_trace_time(t, f"{p}: entry {i}")
                     for i, t in enumerate(doc)]
        elif isinstance(doc, dict):
            key = str(cell)
            if key not in doc:
                raise ValueError(f"{p}: no trace for cell {cell} "
                                 f"(cells present: "
                                 f"{sorted(doc.keys())})")
            entries = doc[key]
            if not isinstance(entries, list):
                raise ValueError(f"{p}: cell {cell} entry must be a "
                                 f"list of timestamps, got "
                                 f"{type(entries).__name__}")
            times = [_trace_time(t, f"{p}: cell {cell} entry {i}")
                     for i, t in enumerate(entries)]
        else:
            raise ValueError(f"{p}: JSON trace must be a list of times "
                             f"or a cell->times object, got "
                             f"{type(doc).__name__}")
        return TraceArrivals(times)

    with p.open(newline="") as fh:
        reader = csv.DictReader(fh)
        cols = reader.fieldnames or []
        if "cell" not in cols or "arrival" not in cols:
            raise ValueError(f"{p}: CSV trace needs 'cell' and "
                             f"'arrival' columns, found {cols}")
        times: List[float] = []
        for i, row in enumerate(reader, start=2):   # 1 is the header
            raw_cell, raw_t = row.get("cell"), row.get("arrival")
            if raw_cell in (None, "") or raw_t in (None, ""):
                raise ValueError(f"{p}: row {i}: missing cell or "
                                 f"arrival value")
            try:
                row_cell = int(raw_cell)
            except ValueError:
                raise ValueError(f"{p}: row {i}: cell {raw_cell!r} is "
                                 f"not an integer") from None
            if row_cell == cell:
                times.append(_trace_time(raw_t, f"{p}: row {i}"))
    return TraceArrivals(times)


def correlated_rates(rng: np.random.Generator, n_cells: int,
                     base_rate: float,
                     correlation: float = 0.5,
                     spread: float = 0.3) -> np.ndarray:
    """Per-cell Poisson rates with correlated load: one shared
    log-normal factor (weight ``correlation``) plus an independent
    per-cell factor, scaled so every rate stays positive with mean
    ``base_rate``.  ``correlation=0`` gives independent cells,
    ``correlation=1`` moves the whole fleet together — the regime
    where arrival-aware placement matters most.
    """
    if not 0.0 <= correlation <= 1.0:
        raise ValueError(f"correlation must be in [0, 1], got "
                         f"{correlation}")
    if n_cells < 1:
        raise ValueError(f"n_cells must be >= 1, got {n_cells}")
    shared = rng.normal(0.0, spread)
    own = rng.normal(0.0, spread, size=n_cells)
    mix = correlation * shared + (1.0 - correlation) * own
    # exp(mix) has mean exp(var/2); divide it out so E[rate]=base_rate
    var = (correlation ** 2 + (1.0 - correlation) ** 2) * spread ** 2
    return base_rate * np.exp(mix - var / 2.0)
