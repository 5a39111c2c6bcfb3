"""The port's ``Provisioner`` against ``repro.api.Provisioner`` on SMOKE:
the same plan and mean FID (exactly) and the same images (1e-4, the
U-Net forward's tolerance), given the same params (conv_out redrawn) and
the reference session's latents.  Plus the port's import rules."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import DiffusionWorkload as JaxWorkload  # noqa: E402
from repro.api import Provisioner as JaxProvisioner  # noqa: E402
from repro.core.service import make_scenario as jax_scenario  # noqa: E402
from repro_torch.api import DiffusionWorkload, Provisioner  # noqa: E402
from repro_torch.configs.ddim_cifar10 import SMOKE  # noqa: E402
from repro_torch.core.service import make_scenario  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from test_torch_unet import redrawn_params  # noqa: E402

KEY = jax.random.PRNGKey(0)
SCN = dict(K=3, tau_min=1.5, tau_max=3.0, seed=2)


def test_run_matches_reference_plan_fid_and_images():
    params = redrawn_params(SMOKE)
    jwl = JaxWorkload(params=params)
    ref = JaxProvisioner(jax_scenario(**SCN), workload=jwl,
                         scheduler="stacking", allocator="inv_se").run(KEY)
    latents = {k: np.asarray(v) for k, v in
               jwl._ex().open_session(ref.plan, KEY).latents.items()}
    wl = DiffusionWorkload(
        cfg=SMOKE, params=params_from_numpy(unet.schema(SMOKE), params,
                                            "cpu"), device="cpu")
    got = Provisioner(make_scenario(**SCN), workload=wl,
                      scheduler="stacking", allocator="inv_se",
                      device="cpu").run(latents=latents)
    np.testing.assert_array_equal(got.allocation, ref.allocation)
    assert got.tau_prime == ref.tau_prime
    assert got.plan.batches == ref.plan.batches
    assert got.plan.start_times == ref.plan.start_times
    assert got.mean_fid == ref.mean_fid
    assert got.outage_rate == ref.outage_rate
    assert sorted(got.content) == sorted(ref.content)
    for k, img in ref.content.items():
        np.testing.assert_allclose(got.content[k], img, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("allocator", ["equal", "inv_se", "pso", "coordinate"])
def test_analytic_pipeline_matches_reference(allocator):
    kw = dict(num_particles=6, iters=3) if allocator == "pso" else \
        dict(rounds=2) if allocator == "coordinate" else {}
    ref = JaxProvisioner(jax_scenario(K=6, seed=3), scheduler="stacking",
                         allocator=allocator, allocator_kwargs=kw).run()
    got = Provisioner(make_scenario(K=6, seed=3), scheduler="stacking",
                      allocator=allocator, allocator_kwargs=kw).run()
    np.testing.assert_array_equal(got.allocation, ref.allocation)
    assert got.plan.batches == ref.plan.batches
    assert got.mean_fid == ref.mean_fid
    assert got.content is None
    assert "mean FID" in got.summary()


def test_workload_by_name_executes_on_cpu():
    rep = Provisioner(make_scenario(**SCN), workload="diffusion",
                      allocator="inv_se", device="cpu").run(timed=True)
    assert sorted(rep.content) == [0, 1, 2]
    for img in rep.content.values():
        assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert [x for x, _ in rep.timings] == rep.plan.batch_sizes()


def test_calibrate_fits_a_delay_model():
    wl = DiffusionWorkload(device="cpu")
    p = Provisioner(make_scenario(**SCN), workload=wl, allocator="inv_se",
                    device="cpu")
    g = p.calibrate(batch_sizes=(1, 2), reps=1)
    assert p.delay is g and np.isfinite([g.a, g.b]).all()


def test_unknown_component_names_raise():
    with pytest.raises(ValueError):
        Provisioner(make_scenario(K=2), scheduler="greedy_jax")
    with pytest.raises(ValueError):
        Provisioner(make_scenario(K=2), allocator="nope")


def test_default_device_needs_a_card():
    """Entry points default to the card and never drop to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        Provisioner(make_scenario(K=2), workload="diffusion")
    with pytest.raises(RuntimeError, match="cuda"):
        DiffusionWorkload()


def test_port_imports_without_jax_or_repro():
    """Every module of repro_torch imports with jax blocked, and no
    module of repro gets loaded."""
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
assert len(names) >= 76, names
assert {"repro_torch.models.ssm", "repro_torch.models.zamba2",
        "repro_torch.kernels.ssd_scan.ops",
        "repro_torch.configs.zamba2_2_7b",
        "repro_torch.core.execution", "repro_torch.core.online",
        "repro_torch.diffusion.bucketed",
        "repro_torch.api.execution",
        "repro_torch.training", "repro_torch.training.optimizer",
        "repro_torch.training.data", "repro_torch.training.checkpoint",
        "repro_torch.training.train", "repro_torch.launch",
        "repro_torch.launch.train", "repro_torch.core.arrays",
        "repro_torch.core.baselines", "repro_torch.core.offset",
        "repro_torch.core.optimal", "repro_torch.api.schedulers",
        "repro_torch.core.torchplan", "repro_torch.core.torchplan.kernels",
        "repro_torch.core.torchplan.backend",
        "repro_torch.core.torchplan.batched",
        "repro_torch.core.torchplan.optimal",
        "repro_torch.core.traffic", "repro_torch.core.multiserver",
        "repro_torch.core.fleet", "repro_torch.api.base",
        "repro_torch.api.online", "repro_torch.api.placements",
        "repro_torch.api.multiserver",
        "repro_torch.api.fleet"} <= set(names), names
from repro_torch.core import arrays
assert arrays.engine_impl("torch").name == "torch"
print(len(names))
"""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_or_repro_import():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "src" / "repro_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    bad = [f"{f.relative_to(root)}: {m.group(0).strip()}"
           for f in files for m in pattern.finditer(f.read_text())]
    assert len(files) >= 78 and not bad, bad
    names = {f.relative_to(root).as_posix() for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "training/__init__", "training/optimizer", "training/data",
        "training/checkpoint", "training/train", "launch/__init__",
        "launch/train", "core/arrays", "core/baselines", "core/offset",
        "core/optimal", "api/schedulers", "core/torchplan/__init__",
        "core/torchplan/kernels", "core/torchplan/backend",
        "core/torchplan/batched", "core/torchplan/optimal",
        "core/traffic", "core/multiserver", "core/fleet", "api/base",
        "api/online", "api/placements", "api/multiserver",
        "api/fleet")} <= names, names
