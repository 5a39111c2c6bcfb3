"""``plan_many`` sharded over devices: the scenario axis split across
cards (or CPU "devices"), the port of ``repro.core.jaxplan.sharded``.

Scenario rows are independent, so the split is embarrassingly parallel,
as in the reference:

* the S axis is padded to ``n_devices * _bucket(ceil(S / n))`` rows, the
  padding all-invalid scenarios that plan to nothing and are stripped
  from the result (a device whose block is all padding converges in
  zero rounds);
* the host-side inputs (level grid, key bits, tie ranks, thresholds) are
  computed once for the whole padded stack, then cut into one block per
  device, so each block runs the SAME search as the unsharded call
  (``kernels._plan_many_block`` / ``_replan_many_block``) on its rows:
  the per-row arithmetic is identical and results are ``==`` to
  ``plan_many`` on one device;
* every block is launched (each on its own device, in a thread of its
  own where there are several cards, since a block's round loop checks
  its device) before any result is read back; the results are then
  copied to the host and concatenated.

``devices``: None or 0 means every device of ``device_scope``'s type
(each card; on the CPU, ``os.cpu_count()`` copies of it, the
counterpart of the reference's forced host device count); an int n the
first n, raising when fewer exist; a sequence (``["cuda:0", "cuda:1"]``,
``["cpu"] * 8``) is taken as it is.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.delay_model import DelayModel
from repro_torch.core.quality_model import PowerLawFID
from repro_torch.core.torchplan import kernels
from repro_torch.core.torchplan.batched import (PlanManyResult, _check_inputs,
                                                _pad_stack, _replan_prep,
                                                _result)

#: the ``devices=`` knob
Devices = Union[None, int, Sequence]


def _available(dev: torch.device) -> list:
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev] * (os.cpu_count() or 1)


def resolve_devices(devices: Devices = None) -> list:
    """The devices a sharded plan runs on: ``None``/``0`` = every device
    of ``device_scope``'s type, an int n = the first n of them (raising
    when there are fewer), or a sequence of devices as it is."""
    if devices is None or (isinstance(devices, int) and devices == 0):
        return _available(kernels.plan_device())
    if isinstance(devices, int):
        avail = _available(kernels.plan_device())
        if devices < 0 or devices > len(avail):
            raise ValueError(
                f"devices={devices} requested but only {len(avail)} "
                f"{kernels.plan_device().type} device(s) are there")
        return avail[:devices]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("devices must name at least one device")
    return devs


def _run_blocks(devs, block, per_row, shared, Sp: int):
    """``block(*rows, *shared)`` on each device's slice of the per-row
    arrays (leading axis ``Sp``); returns each block's outputs, still
    on its device."""
    D = len(devs)
    rows = Sp // D

    def one(i):
        dev = devs[i]
        sl = slice(i * rows, (i + 1) * rows)
        mine = kernels._on(dev, *[a[sl] for a in per_row])
        rest = kernels._on(dev, *shared[0])
        return block(*mine, *rest, *shared[1])
    cards = {d for d in devs if d.type == "cuda"}
    if len(cards) > 1:
        with ThreadPoolExecutor(len(devs)) as pool:
            return list(pool.map(one, range(D)))
    return [one(i) for i in range(D)]


def _gather(lv_p, S, K, outs) -> PlanManyResult:
    """The blocks' results read back (one read each) and concatenated,
    the padding cut."""
    parts = [_result(lv_p, o[0].shape[0], K, *o) for o in outs]
    return PlanManyResult(
        best_level=np.concatenate([p.best_level for p in parts])[:S],
        steps=np.concatenate([p.steps for p in parts])[:S],
        mean_fid=np.concatenate([p.mean_fid for p in parts])[:S],
        makespan=np.concatenate([p.makespan for p in parts])[:S])


def plan_many_sharded(tau_prime: np.ndarray, *, delay: DelayModel,
                      quality: PowerLawFID,
                      offsets: Optional[np.ndarray] = None,
                      valid: Optional[np.ndarray] = None,
                      t_star_max: int = 0,
                      devices: Devices = None) -> PlanManyResult:
    """``plan_many`` with the scenario axis sharded across devices.

    Same inputs and result type as ``plan_many`` plus ``devices`` (see
    ``resolve_devices``).  S is padded up to the device count's blocks
    with all-invalid scenario rows, stripped from the result, so S need
    not be divisible by (or even as large as) the device count."""
    devs = resolve_devices(devices)
    D = len(devs)
    taup0, off, vd, S, K = _check_inputs(tau_prime, quality, offsets,
                                         valid)
    Sp = D * kernels._bucket(max(1, -(-S // D)))
    taup_p, off_p, vd_p, tie, f_thr, lv_p, shift, kb = _pad_stack(
        taup0, off, vd, delay, t_star_max, Sp)
    outs = _run_blocks(
        devs, kernels._plan_many_block, (taup_p, off_p, vd_p, tie, f_thr),
        ((lv_p,), (shift, delay.a, delay.b, quality.alpha, quality.beta,
                   quality.gamma, quality.fid_at_zero, kb)), Sp)
    return _gather(lv_p, S, K, outs)


def replan_many_sharded(tau_prime: np.ndarray, *, delay: DelayModel,
                        quality: PowerLawFID,
                        offsets: Optional[np.ndarray] = None,
                        doomed: Optional[np.ndarray] = None,
                        valid: Optional[np.ndarray] = None,
                        t_star_max: int = 0,
                        devices: Devices = None) -> PlanManyResult:
    """``replan_many`` with the scenario axis sharded across devices:
    the shared-horizon residual-replan semantics of ``replan_many``
    with the split of ``plan_many_sharded``."""
    devs = resolve_devices(devices)
    D = len(devs)
    taup0, soff, vd, S, K = _check_inputs(tau_prime, quality, offsets,
                                          valid)
    dm = np.zeros((S, K), dtype=bool) if doomed is None \
        else np.broadcast_to(np.asarray(doomed, dtype=bool),
                             (S, K)).copy()
    Sp = D * kernels._bucket(max(1, -(-S // D)))
    (taup_p, soff_p, vd_p, dm_p, tie, f_thr, lv_p, lv_ok, shift,
     kb) = _replan_prep(taup0, soff, vd, dm, delay, t_star_max, Sp)

    def block(taup, soff, vd, dm, tie, f_thr, lv_ok, lv, *rest):
        return kernels._replan_many_block(taup, soff, vd, dm, tie, f_thr,
                                          lv, lv_ok, *rest)
    outs = _run_blocks(
        devs, block, (taup_p, soff_p, vd_p, dm_p, tie, f_thr, lv_ok),
        ((lv_p,), (shift, delay.a, delay.b, quality.alpha, quality.beta,
                   quality.gamma, quality.fid_at_zero, kb)), Sp)
    return _gather(lv_p, S, K, outs)
