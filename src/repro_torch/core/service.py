"""AIGC service requests and scenario generation (Sec. II / IV constants).

K devices, deadlines uniform in [tau_min, tau_max] (paper: 7..20 s),
spectral efficiency eta_k uniform in [5, 10] bit/s/Hz, total bandwidth
B = 40 kHz, content size S identical across services (one generated
image; default 3 KiB ~= a 32x32 PNG), or per service when
``content_bits_range`` is given.

A copy of ``repro.core.service``'s single-server setting; a given seed
draws the same scenario as the original.  ``arrival`` is the request's
submission time (0 = the paper's static batch; ``arrival_rate`` draws a
Poisson process for ``core/online.py``).  Multi-server cells are not
part of this port yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

DEFAULT_BANDWIDTH_HZ = 40_000.0
DEFAULT_CONTENT_BITS = 3 * 1024 * 8.0


@dataclasses.dataclass(frozen=True)
class ServiceRequest:
    id: int
    deadline: float            # tau_k, end-to-end, relative to arrival (s)
    spectral_eff: float        # eta_k (bit/s/Hz)
    arrival: float = 0.0       # submission time (0 = the paper's static batch)
    content_bits: Optional[float] = None   # per-service S; None = scenario's

    def tx_delay(self, bandwidth_hz: float,
                 content_bits: float = DEFAULT_CONTENT_BITS) -> float:
        """D_ct = S / (B_k * eta_k)  (Eqs. 8, 11); a per-service
        ``self.content_bits`` takes precedence over the scenario's."""
        bits = self.content_bits if self.content_bits is not None \
            else content_bits
        rate = bandwidth_hz * self.spectral_eff
        return bits / max(rate, 1e-12)


@dataclasses.dataclass(frozen=True)
class Scenario:
    services: List[ServiceRequest]
    total_bandwidth_hz: float = DEFAULT_BANDWIDTH_HZ
    content_bits: float = DEFAULT_CONTENT_BITS

    @property
    def K(self) -> int:
        return len(self.services)


def make_scenario(K: int = 20, tau_min: float = 7.0, tau_max: float = 20.0,
                  eta_min: float = 5.0, eta_max: float = 10.0,
                  total_bandwidth_hz: float = DEFAULT_BANDWIDTH_HZ,
                  content_bits: float = DEFAULT_CONTENT_BITS,
                  arrival_rate: Optional[float] = None,
                  content_bits_range: Optional[Tuple[float, float]] = None,
                  seed: int = 0) -> Scenario:
    """Sample a K-service scenario (Sec. IV constants by default).

    arrival_rate: requests/s of a Poisson arrival process; service k
        arrives at the k-th arrival epoch.  ``None`` keeps every
        arrival at t=0.
    content_bits_range: (lo, hi) uniform per-service content sizes.

    Both are drawn after the base loop, in this order, so a seed's
    deadlines and spectral efficiencies do not change with them.
    """
    rng = np.random.default_rng(seed)
    services = [
        ServiceRequest(
            id=k,
            deadline=float(rng.uniform(tau_min, tau_max)),
            spectral_eff=float(rng.uniform(eta_min, eta_max)),
        )
        for k in range(K)
    ]
    if arrival_rate is not None:
        if arrival_rate <= 0:
            raise ValueError("arrival_rate must be positive (requests/s)")
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, size=K))
        services = [dataclasses.replace(s, arrival=float(t))
                    for s, t in zip(services, arrivals)]
    if content_bits_range is not None:
        lo, hi = content_bits_range
        bits = rng.uniform(lo, hi, size=K)
        services = [dataclasses.replace(s, content_bits=float(b))
                    for s, b in zip(services, bits)]
    return Scenario(services=services,
                    total_bandwidth_hz=total_bandwidth_hz,
                    content_bits=content_bits)
