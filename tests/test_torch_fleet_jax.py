"""The port's fleet on the torch planner engine (on the CPU) against
the reference's fleet on its jax engine, within 1e-9 mean FID with equal
counts and equal planner calls: epoch mode on tests/test_fleet.py's
10-cell fleet, event mode on its ``small_fleet(4, 3.0, 6.0)``.

``repro.core.jaxplan`` fails to import under jax 0.9.0 (``from
jax.experimental import enable_x64``), so the reference's fleet runs in
a child process that first sets ``jax.experimental.enable_x64 =
jax.enable_x64``, as tests/test_torch_planner_jax.py does.  The test
process itself is never shimmed: the reference's own jax fleet tests
must fail or pass the same way in every worker."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fleet as pf  # noqa: E402
from repro_torch.core import traffic as pt  # noqa: E402
from repro_torch.core.torchplan import device_scope  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9
COUNTS = ("arrivals", "admitted", "rejected", "completed", "replans",
          "peak_live_rows", "planner_calls")

# The child: both fleets on the reference's jax engine.
CHILD = r"""
import dataclasses, json, sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # jax 0.9.0 renamed it
from repro.core import fleet as fl, traffic as tr
sys.path.insert(0, sys.argv[2])
from test_torch_fleet_jax import FLEETS
out = {name: dataclasses.asdict(fl.simulate_fleet(make(fl, tr), mode=mode,
                                                  engine="jax"))
       for name, (make, mode) in FLEETS.items()}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


def epoch_fleet(fl, tr):
    cells = [fl.FleetCell(bandwidth_hz=2e6, process=tr.PoissonProcess(5.0))
             for _ in range(10)]
    return fl.FleetScenario(cells=cells, horizon=30.0, seed=1)


def event_fleet(fl, tr):
    cells = [fl.FleetCell(bandwidth_hz=1.2e6 * (c + 1),
                          speed=1.0 + 0.25 * c,
                          process=tr.PoissonProcess(3.0))
             for c in range(4)]
    return fl.FleetScenario(cells=cells, horizon=6.0, seed=11)


#: name -> (fleet in module fl, mode)
FLEETS = {"epoch": (epoch_fleet, "epoch"), "event": (event_fleet, "event")}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("fleet_jax") / "ref.json"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("REPRO_PLANNER_ENGINE", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, str(path),
                           str(ROOT / "tests")], capture_output=True,
                          text=True, timeout=600, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(path.read_text())


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_torch_fleet_matches_jax_engine(ref, name):
    make, mode = FLEETS[name]
    want = ref[name]
    with device_scope("cpu"):
        got = pf.simulate_fleet(make(pf, pt), mode=mode, engine="torch")
    assert want["engine"] == "jax" and got.engine == "torch"
    assert abs(got.mean_fid - want["mean_fid"]) < TOL
    assert abs(got.outage_rate - want["outage_rate"]) < 1e-12
    assert [getattr(got, k) for k in COUNTS] == [want[k] for k in COUNTS]
    # event rounds split by cell speed, and the 4 cells have 4 speeds
    assert got.planner_calls < got.replans if mode == "epoch" else \
        got.planner_calls == got.replans
