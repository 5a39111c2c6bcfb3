"""The frozen copies equal the port's functions they were copied from,
at several seeds: inv_se, STACKING (first plans
and offset replans), the quality models and the DDIM schedules."""

import sys
from pathlib import Path

import numpy as np
import pytest

PB = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PB))

from harness import frozen  # noqa: E402
from harness.traffic import round_requests  # noqa: E402
from repro_torch.core import bandwidth, service  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.online import _OffsetQuality  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.diffusion import ddim  # noqa: E402
from repro_torch.serving.engine import TokenQuality  # noqa: E402

SEEDS = [0, 1, 7, 2**31 + 11, 98765432109]


@pytest.mark.parametrize("seed", SEEDS)
def test_inv_se_and_tau_prime(seed):
    scn = service.make_scenario(K=32, tau_min=0.35, tau_max=1.0,
                                total_bandwidth_hz=8e5, seed=seed)
    alloc = bandwidth.inv_se_allocate(scn)
    effs = [s.spectral_eff for s in scn.services]
    assert np.array_equal(frozen.inv_se(effs, 8e5), alloc)
    ids = [s.id for s in scn.services]
    assert frozen.tau_prime(
        ids, [s.deadline for s in scn.services], effs, alloc,
        scn.content_bits) == bandwidth.tau_prime_of(scn, alloc)


def _plan(services, taup, delay, quality):
    p = stacking(services, taup, delay, quality)
    return ([[k for k, _ in b] for b in p.batches],
            {k: int(v) for k, v in p.steps_completed.items()})


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["ddim", "decode"])
def test_stacking_first_plan(seed, kind):
    if kind == "ddim":
        scn = service.make_scenario(K=32, tau_min=0.35, tau_max=1.0,
                                    total_bandwidth_hz=8e5, seed=seed)
        delay, q, fq = DelayModel(0.00031, 0.0049), PowerLawFID(), \
            frozen.PowerLawFID()
    else:
        scn = service.make_scenario(K=32, tau_min=1.75, tau_max=5.0,
                                    total_bandwidth_hz=1.6e5, seed=seed)
        delay, q, fq = DelayModel(0.0006, 0.055), TokenQuality(), \
            frozen.TokenQuality()
    alloc = bandwidth.inv_se_allocate(scn)
    taup = bandwidth.tau_prime_of(scn, alloc)
    ids = [s.id for s in scn.services]
    got = frozen.stacking(ids, taup, frozen.Delay(delay.a, delay.b),
                          frozen.OffsetQuality(fq, [0] * len(ids), ids,
                                               taup))
    want = _plan(scn.services, taup, delay, q)
    assert ([[k for k, _ in b] for b in got[0]], got[1]) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_stacking_replan_with_offsets(seed):
    r = np.random.default_rng(seed)
    scn = service.make_scenario(K=20, tau_min=0.2, tau_max=0.7,
                                total_bandwidth_hz=8e5, seed=seed)
    ids = [s.id for s in scn.services]
    offsets = [int(x) for x in r.integers(0, 12, len(ids))]
    taup = {k: float(t) for k, t in zip(ids, r.uniform(-0.05, 0.6,
                                                         len(ids)))}
    delay = DelayModel(0.0004, 0.006)
    oq = _OffsetQuality(PowerLawFID(), offsets)
    oq.refresh_doomed(scn.services, taup)
    want = _plan(scn.services, taup, delay, oq)
    fq = frozen.OffsetQuality(frozen.PowerLawFID(), offsets, ids, taup)
    got = frozen.stacking(ids, taup, frozen.Delay(delay.a, delay.b), fq)
    assert ([[k for k, _ in b] for b in got[0]], got[1]) == want


def test_quality_models():
    for T in range(0, 400):
        assert frozen.PowerLawFID().fid(T) == PowerLawFID().fid(T)
        assert frozen.TokenQuality().fid(T) == TokenQuality().fid(T)


@pytest.mark.parametrize("T", [1, 2, 7, 31, 64, 999, 1000, 1500])
def test_ddim_schedules(T):
    assert frozen.ddim_timesteps(T) == [int(t)
                                        for t in ddim.ddim_timesteps(T)]
    for start in (999, 517, 3):
        assert frozen.retarget_timesteps(start, T) == [
            int(t) for t in ddim.retarget_timesteps(start, T)]
    assert np.array_equal(frozen.alphas_cumprod(), ddim.alphas_cumprod())


def test_rounds_carry_the_same_work_in_another_order():
    t = {"K": 32, "deadline_s": [0.35, 1.0], "spectral_eff": [5.0, 10.0]}
    a = round_requests(t, 2**40 + 3, 5)
    b = round_requests(t, 2**40 + 3, 5)
    c = round_requests(t, 7, 6)
    assert a == b and a != c
    for x, y in ((a, c),):
        assert sorted(q.deadline for q in x) == sorted(q.deadline for q in y)
        assert sorted(q.spectral_eff for q in x) == sorted(
            q.spectral_eff for q in y)
    assert [q.id for q in c] == list(range(6 * 32, 7 * 32))
    d = sorted(q.deadline for q in a)
    assert d[0] > 0.35 and d[-1] < 1.0 and np.allclose(np.diff(d),
                                                       0.65 / 32)
