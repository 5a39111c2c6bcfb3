"""DDIM sampling [arXiv:2010.02502] with arbitrary step-subsequences and
per-sample schedules, in PyTorch.

The NumPy schedule helpers are copies of ``repro.diffusion.ddim``'s
(tests/test_torch_ddim.py holds them equal).  ``ddim_step`` advances a
*mixed* batch (different services, step indices and schedules) in ONE
batched U-Net call.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


def make_betas(num_timesteps: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_timesteps,
                       dtype=np.float64)


def alphas_cumprod(num_timesteps: int = 1000) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(num_timesteps))


def ddim_timesteps(T: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """Evenly spaced T-step subsequence (descending, t_1 > ... > t_T)."""
    if T >= num_train_timesteps:
        return np.arange(num_train_timesteps)[::-1].copy()
    step = num_train_timesteps / T
    ts = (np.arange(T) * step).round().astype(np.int64)
    return ts[::-1].copy()


def schedule_table(T: int, num_train_timesteps: int = 1000) -> np.ndarray:
    """(T+1,) timestep table: entry i = timestep for step index i; the last
    entry is -1 ("fully denoised")."""
    ts = ddim_timesteps(T, num_train_timesteps)
    return np.concatenate([ts, [-1]])


def retarget_timesteps(t_start: int, T: int) -> np.ndarray:
    """Evenly spaced descending T-step subsequence from ``t_start`` down
    to 0 — rescheduling a partially denoised chain mid-run when a replan
    changes its total step count."""
    if T <= 0:
        return np.zeros((0,), np.int64)
    return np.round(np.linspace(float(t_start), 0.0, T)).astype(np.int64)


@functools.lru_cache(maxsize=8)
def _acp_table(num_train_timesteps: int, device: torch.device):
    # built in float64, cast to float32, as the reference does
    return torch.as_tensor(alphas_cumprod(num_train_timesteps),
                           dtype=torch.float32).to(device)


def ddim_step(eps_fn, x, t_now, t_next, num_train_timesteps: int = 1000):
    """One deterministic DDIM update with *per-sample* timesteps.

    x: (B, H, W, C); t_now, t_next: (B,) integer tensors on x's device
    (t_next = -1 -> alpha_bar = 1; t_now < 0 -> the row passes through).
    eps_fn(x, t) -> predicted noise.
    """
    acp = _acp_table(num_train_timesteps, x.device)
    a_now = acp[t_now.clamp(min=0)]
    a_next = torch.where(t_next < 0, torch.ones_like(a_now),
                         acp[t_next.clamp(min=0)])
    eps = eps_fn(x, t_now.float())
    bshape = (-1,) + (1,) * (x.dim() - 1)
    a_now = a_now.reshape(bshape)
    a_next = a_next.reshape(bshape)
    x0 = (x - torch.sqrt(1.0 - a_now) * eps) / torch.sqrt(a_now)
    x_next = torch.sqrt(a_next) * x0 + torch.sqrt(1.0 - a_next) * eps
    active = (t_now >= 0).reshape(bshape)
    return torch.where(active, x_next, x)


def sample(eps_fn, generator: torch.Generator, shape: Tuple[int, ...],
           T: int, device, num_train_timesteps: int = 1000):
    """Plain (single-service) DDIM sampling loop: T steps, batch `shape`.
    The initial noise is drawn on the generator's device."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device).to(device)
    ts = ddim_timesteps(T, num_train_timesteps)
    ts_next = np.concatenate([ts[1:], [-1]])
    B = shape[0]
    for t_now, t_next in zip(ts, ts_next):
        tn = torch.full((B,), int(t_now), dtype=torch.int64, device=device)
        tx = torch.full((B,), int(t_next), dtype=torch.int64, device=device)
        x = ddim_step(eps_fn, x, tn, tx, num_train_timesteps)
    return x
