"""``plan_many`` sharded over devices (``repro_torch.core.torchplan.
sharded``): ``plan_many_sharded`` and ``replan_many_sharded`` on 1, 2
and 8 CPU "devices", S not divisible by D and S < D, ``==`` to the
unsharded calls; the ``devices=`` knob of the batched calls and of the
fleet; and the reference's ``plan_many_sharded`` at 8 host devices
within 1e-9 mean FID.

The reference runs in a child process that forces 8 host devices and
sets ``jax.experimental.enable_x64 = jax.enable_x64`` first (jax 0.9.0
renamed it), as tests/test_torch_planner_jax.py does; this process is
never shimmed."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api.fleet import (FleetProvisioner,  # noqa: E402
                                   make_fleet_scenario)
from repro_torch.core import torchplan  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.torchplan import (device_scope,  # noqa: E402
                                        plan_many_sharded,
                                        replan_many_sharded,
                                        resolve_devices)

ROOT = Path(__file__).resolve().parents[1]
DELAY, QUALITY = DelayModel(), PowerLawFID()
TOL = 1e-9
FIELDS = ("best_level", "steps", "mean_fid", "makespan")
SIZES = (1, 5, 13, 40)          # S < D, S not divisible by D, S > D

CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # jax 0.9.0 renamed it
import numpy as np
from repro.core.delay_model import DelayModel
from repro.core.jaxplan import sharded
from repro.core.quality_model import PowerLawFID
D, Q = DelayModel(), PowerLawFID()
assert len(jax.devices()) == 8
rng = np.random.default_rng(31)
out = {}
for S in (1, 5, 13, 40):
    t = rng.uniform(0.2, 5.0, size=(S, 7))
    r = sharded.plan_many_sharded(t, delay=D, quality=Q, devices=8)
    out[f"pm_taus_{S}"], out[f"pm_fid_{S}"] = t, r.mean_fid
    out[f"pm_steps_{S}"] = r.steps
    rt = rng.uniform(-1.0, 6.0, size=(S, 7))
    ro = rng.integers(0, 9, size=(S, 7))
    rd = (ro > 0) & (rt < 0)
    r = sharded.replan_many_sharded(rt, delay=D, quality=Q, offsets=ro,
                                    doomed=rd, devices=8)
    out[f"rm_taus_{S}"], out[f"rm_offs_{S}"] = rt, ro
    out[f"rm_doomed_{S}"], out[f"rm_fid_{S}"] = rd, r.mean_fid
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(autouse=True)
def on_cpu():
    with device_scope("cpu"):
        yield


def _equal(a, b):
    for f in FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def _stack(S, seed=0):
    rng = np.random.default_rng(seed + S)
    taus = rng.uniform(0.2, 5.0, size=(S, 6))
    valid = np.ones(taus.shape, dtype=bool)
    valid[::3, 4:] = False
    offs = rng.integers(0, 6, size=(S, 6))
    return taus, valid, offs


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("S", SIZES)
def test_plan_many_sharded_equals_unsharded(S, D):
    taus, valid, offs = _stack(S)
    want = torchplan.plan_many(taus, delay=DELAY, quality=QUALITY,
                               valid=valid, offsets=offs)
    got = plan_many_sharded(taus, delay=DELAY, quality=QUALITY,
                            valid=valid, offsets=offs, devices=["cpu"] * D)
    _equal(want, got)
    assert got.num_scenarios == S


@pytest.mark.parametrize("D", [1, 2, 8])
@pytest.mark.parametrize("S", SIZES)
def test_replan_many_sharded_equals_unsharded(S, D):
    taus, valid, offs = _stack(S, 7)
    taus = taus - 1.0
    doomed = (offs > 0) & (taus < 0)
    want = torchplan.replan_many(taus, delay=DELAY, quality=QUALITY,
                                 offsets=offs, doomed=doomed, valid=valid)
    got = replan_many_sharded(taus, delay=DELAY, quality=QUALITY,
                              offsets=offs, doomed=doomed, valid=valid,
                              devices=["cpu"] * D)
    _equal(want, got)


def test_devices_knob():
    """``devices=`` of the batched calls routes to the sharded ones;
    None/0 is every CPU "device", an int the first n, a sequence as it
    is, and more than there are raises."""
    n = os.cpu_count() or 1
    assert len(resolve_devices(None)) == n == len(resolve_devices(0))
    assert resolve_devices(2) == [torch.device("cpu")] * 2
    assert resolve_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="only"):
        resolve_devices(n + 1)
    with pytest.raises(ValueError, match="at least one"):
        resolve_devices([])
    taus, valid, _ = _stack(13)
    want = torchplan.plan_many(taus, delay=DELAY, quality=QUALITY,
                               valid=valid)
    for devices in (None, 0, 2, ["cpu"] * 3):
        _equal(want, torchplan.plan_many(taus, delay=DELAY, quality=QUALITY,
                                         valid=valid, devices=devices))


def test_fleet_devices_equal():
    """``FleetProvisioner(engine="torch", devices=2)`` gives the results of
    ``devices=None``."""
    fleet = make_fleet_scenario(6, 20.0, rate=2.0, bandwidth_hz=2e6, seed=2)
    a = FleetProvisioner(fleet, allocator="inv_se", engine="torch",
                         device="cpu").run().result
    b = FleetProvisioner(fleet, allocator="inv_se", engine="torch",
                         device="cpu", devices=2).run().result
    assert a.mean_fid == b.mean_fid and a.outage_rate == b.outage_rate
    assert a.planner_calls == b.planner_calls and a.replans == b.replans


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jaxplan_sharded") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("REPRO_PLANNER_ENGINE", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, str(path)],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("S", SIZES)
def test_against_the_reference_at_8_devices(ref, S):
    got = plan_many_sharded(ref[f"pm_taus_{S}"], delay=DELAY,
                            quality=QUALITY, devices=["cpu"] * 8)
    np.testing.assert_allclose(got.mean_fid, ref[f"pm_fid_{S}"], rtol=0,
                               atol=TOL)
    assert np.array_equal(got.steps, ref[f"pm_steps_{S}"])
    got = replan_many_sharded(ref[f"rm_taus_{S}"], delay=DELAY,
                              quality=QUALITY, offsets=ref[f"rm_offs_{S}"],
                              doomed=ref[f"rm_doomed_{S}"],
                              devices=["cpu"] * 8)
    np.testing.assert_allclose(got.mean_fid, ref[f"rm_fid_{S}"], rtol=0,
                               atol=TOL)
