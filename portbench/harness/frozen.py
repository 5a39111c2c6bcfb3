"""Frozen copies of the program's planner, quality models and DDIM
schedules, in NumPy and plain Python.

The benchmark judges the program's plans and scores what users
received with these copies, never with the program's own
code, so a later change to the program cannot move the yardstick.
Each is a copy of the port's function of the same name as it stood
when the benchmark was defined (``core/service.py``'s transmission
delay, ``core/bandwidth.py``, ``core/stacking.py``, ``core/online.py``'s
offset quality, ``core/quality_model.py``, ``serving/engine.py``);
``portbench/tests/test_portbench_frozen.py`` holds them equal to it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# Transmission (core/service.py)
# ---------------------------------------------------------------------------

def tx_delay(bits: float, bandwidth_hz: float, spectral_eff: float) -> float:
    """D_ct = S / (B_k eta_k) (Eqs. 8, 11)."""
    return bits / max(bandwidth_hz * spectral_eff, 1e-12)


# ---------------------------------------------------------------------------
# Quality models
# ---------------------------------------------------------------------------

class PowerLawFID:
    """FID(T) = alpha T^-beta + gamma; fid(0) = 550 (an outage)."""
    alpha, beta, gamma, fid_at_zero = 491.0, 1.72, 4.0, 550.0

    def fid(self, steps: int) -> float:
        if steps <= 0:
            return self.fid_at_zero
        return self.alpha * steps ** (-self.beta) + self.gamma

    def mean_fid(self, step_counts: Sequence[int]) -> float:
        return float(np.mean([self.fid(t) for t in step_counts]))


class TokenQuality:
    """100 / (1 + T) for T decoded tokens; 100 for none."""
    penalty_at_zero = 100.0

    def fid(self, steps: int) -> float:
        if steps <= 0:
            return self.penalty_at_zero
        return self.penalty_at_zero / (1.0 + steps)

    def mean_fid(self, step_counts: Sequence[int]) -> float:
        return float(np.mean([self.fid(t) for t in step_counts]))


QUALITY = {"power_law_fid": PowerLawFID, "token_quality": TokenQuality}


class OffsetQuality:
    """A replan's objective (``core/online.py``'s ``_OffsetQuality``):
    a residual count vector scores fid(done + new), and a service with
    steps done whose tau' went negative scores fid(0)."""

    def __init__(self, base, offsets: List[int], services, tau_prime):
        self.base = base
        self.offsets = offsets
        self.doomed = {i for i, s in enumerate(services)
                       if offsets[i] > 0 and tau_prime[s] < 0}

    def fid(self, steps: int) -> float:
        return self.base.fid(steps)

    def mean_fid(self, step_counts) -> float:
        if len(step_counts) != len(self.offsets):
            return float(np.mean([self.base.fid(t) for t in step_counts]))
        return float(np.mean([
            self.base.fid(0) if i in self.doomed
            else self.base.fid(self.offsets[i] + t)
            for i, t in enumerate(step_counts)]))


# ---------------------------------------------------------------------------
# Delay model g(X) = aX + b (core/delay_model.py)
# ---------------------------------------------------------------------------

class Delay:
    def __init__(self, a: float, b: float):
        self.a, self.b = float(a), float(b)

    def g(self, x: int) -> float:
        return 0.0 if x <= 0 else self.a * x + self.b

    def min_task_delay(self) -> float:
        return self.g(1)

    def max_steps(self, budget: float) -> int:
        return 0 if budget <= 0 else int(budget / (self.a + self.b))


# ---------------------------------------------------------------------------
# P1: bandwidth (core/bandwidth.py)
# ---------------------------------------------------------------------------

def inv_se(spectral_effs: Sequence[float], total_hz: float) -> np.ndarray:
    """Equal transmission delay: B_k proportional to 1/eta_k."""
    inv = np.array([1.0 / e for e in spectral_effs])
    return total_hz * inv / inv.sum()


def tau_prime(ids, deadlines, spectral_effs, alloc, bits) -> Dict[int, float]:
    return {k: d - tx_delay(bits, b, e)
            for k, d, e, b in zip(ids, deadlines, spectral_effs, alloc)}


# ---------------------------------------------------------------------------
# P2: STACKING, Algorithm 1 (core/stacking.py, the scalar reference loop)
# ---------------------------------------------------------------------------

def stacking_pass(ids: Sequence[int], taup0: Dict[int, float], delay: Delay,
                  t_star: int):
    """One clustering-packing-batching sweep at level T*.  Returns
    (batches [[(k, step)]], steps {k: T_k})."""
    a, b = delay.a, delay.b
    taup = {k: float(taup0[k]) for k in ids}
    Tc = {k: 0 for k in ids}
    active = [k for k in ids if taup[k] >= delay.min_task_delay()]
    batches: List[List] = []
    while active:
        Te = {k: delay.max_steps(taup[k]) for k in active}
        Tp = {k: Tc[k] + Te[k] for k in active}
        order = sorted(active, key=lambda k: (Tp[k], taup[k], k))
        F = [k for k in order if Tp[k] <= t_star]
        if F:
            te_max = max(Te[k] for k in F)
            tau_min = min(taup[k] for k in F)
            if te_max > 0:
                cap = math.floor((tau_min - b * te_max) / (a * te_max))
                x_n = max(len(F), min(len(active), cap))
            else:
                x_n = len(F)
        else:
            tp_min = min(Tp[k] for k in active)
            cap = math.floor(((a + b) * tp_min - b * t_star)
                             / (a * t_star)) if t_star > 0 else len(active)
            x_n = min(len(active), max(1, cap))
        x_n = max(1, min(x_n, len(active)))
        packed = order[:x_n]
        while packed:
            g = delay.g(len(packed))
            drop = [k for k in packed if taup[k] + 1e-12 < g]
            if not drop:
                break
            for k in drop:
                packed.remove(k)
                active.remove(k)
        if not packed:
            continue
        g = delay.g(len(packed))
        batches.append([(k, Tc[k]) for k in packed])
        for k in active:
            taup[k] -= g
        for k in packed:
            Tc[k] += 1
        active = [k for k in active
                  if taup[k] + 1e-12 >= delay.min_task_delay()]
    return batches, Tc


def stacking(ids: Sequence[int], taup: Dict[int, float], delay: Delay,
             quality, t_star_max: int = 0):
    """Algorithm 1: the first strictly best T* in 1..T*max by mean
    quality.  Returns (batches, steps)."""
    if t_star_max <= 0:
        t_star_max = max(1, max(delay.max_steps(taup[k]) for k in ids))
    best, best_q = None, float("inf")
    for t_star in range(1, t_star_max + 1):
        batches, Tc = stacking_pass(ids, taup, delay, t_star)
        q = quality.mean_fid([Tc[k] for k in ids])
        if q < best_q - 1e-12:
            best, best_q = (batches, Tc), q
    if best is None:
        raise ValueError("stacking: no T* candidate produced a plan")
    return best


# ---------------------------------------------------------------------------
# DDIM schedules (diffusion/ddim.py)
# ---------------------------------------------------------------------------

def ddim_timesteps(T: int, num_train_timesteps: int = 1000) -> List[int]:
    """Evenly spaced T-step subsequence, descending."""
    if T >= num_train_timesteps:
        return list(range(num_train_timesteps))[::-1]
    step = num_train_timesteps / T
    ts = (np.arange(T) * step).round().astype(np.int64)
    return [int(t) for t in ts[::-1]]


def retarget_timesteps(t_start: int, T: int) -> List[int]:
    """T evenly spaced steps from t_start down to 0 (a replanned chain)."""
    if T <= 0:
        return []
    return [int(t) for t in
            np.round(np.linspace(float(t_start), 0.0, T)).astype(np.int64)]


def alphas_cumprod(num_train_timesteps: int = 1000,
                   beta_start: float = 1e-4,
                   beta_end: float = 0.02) -> np.ndarray:
    betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                        dtype=np.float64)
    return np.cumprod(1.0 - betas)


def schedule_of(session_log, initial_totals: Dict[int, int], k: int,
                num_train_timesteps: int = 1000):
    """Service k's (t_now, t_next) at each step it ran, worked out from
    its planned totals and the session's calls (``RoundLog``): a new
    chain per total at the start, the chain shortened or stretched from
    its next timestep at a retarget (``DenoiseSession``'s rules)."""
    T = initial_totals.get(k, 0)
    rem = list(ddim_timesteps(T, num_train_timesteps)) if T > 0 else []
    done, steps = 0, []
    for ev in session_log:
        if ev[0] == "batch":
            if k in ev[1]:
                if not rem:
                    raise ValueError(f"service {k} stepped past its chain")
                steps.append((rem[0], rem[1] if len(rem) > 1 else -1))
                rem.pop(0)
                done += 1
        elif k in ev[1]:
            extra = int(ev[1][k]) - done
            if extra <= 0:
                rem = []
            elif done == 0:
                rem = ddim_timesteps(extra, num_train_timesteps)
            else:
                rem = retarget_timesteps(rem[0], extra) if rem else []
    return steps
