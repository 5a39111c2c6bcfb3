"""The port's device planner engine (``repro_torch.core.torchplan``, on
the CPU) against the reference's jax engine (``repro.core.jaxplan``),
within 1e-9 mean FID, the tolerance of tests/test_jaxplan.py.

``repro.core.jaxplan`` does ``from jax.experimental import enable_x64``,
which jax 0.9.0 no longer has (it has ``jax.enable_x64``), so the
reference engine fails to import as it stands.  It runs unchanged in a
child process that first sets ``jax.experimental.enable_x64 =
jax.enable_x64``; that process draws every instance from a seed, runs
the jax engine and writes inputs and results to an ``.npz``.  The test
process itself is never shimmed: the reference's own jaxplan tests must
fail or pass the same way in every worker."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import arrays, optimal  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.offset import StackingOffset  # noqa: E402
from repro_torch.core.online import _OffsetQuality  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.service import ServiceRequest  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.core.torchplan import (device_scope, plan_many,  # noqa: E402
                                        replan_many)
from repro_torch.api.schedulers import equal_steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DELAY, QUALITY = DelayModel(), PowerLawFID()
TOL = 1e-9

# The child: every instance from one seed, the jax engine on each.
CHILD = r"""
import sys
import jax, jax.experimental
jax.experimental.enable_x64 = jax.enable_x64      # jax 0.9.0 renamed it
import numpy as np
import repro.core.jaxplan as jaxplan
from repro.api.schedulers import equal_steps
from repro.core import arrays
from repro.core.delay_model import DelayModel
from repro.core.offset import StackingOffset
from repro.core.online import _OffsetQuality
from repro.core.optimal import optimal_mean_fid, optimal_plan
from repro.core.quality_model import PowerLawFID
from repro.core.service import ServiceRequest
D, Q = DelayModel(), PowerLawFID()

def svcs(taus):
    return ([ServiceRequest(id=i, deadline=float(t), spectral_eff=7.0)
             for i, t in enumerate(taus)],
            {i: float(t) for i, t in enumerate(taus)})

def fid(plan, q, K):
    return q.mean_fid([plan.steps_completed[k] for k in range(K)])

rng = np.random.default_rng(23)
out = {}
# stacking and equal_steps: K of 1..13 (one K bucket), tie-heavy rows too
taus = [rng.uniform(0.1, 6.0, size=int(k)) for k in rng.integers(1, 14, 6)]
taus += [np.array([2.5] * 5 + [4.0] * 3), np.array([3.0] * 8)]
for i, t in enumerate(taus):
    s, tp = svcs(t)
    out[f"stacking_taus_{i}"] = t
    out[f"stacking_fid_{i}"] = fid(
        jaxplan.stacking(s, tp, D, Q), Q, t.size)
    out[f"equal_steps_fid_{i}"] = fid(
        jaxplan.equal_steps(s, tp, D, Q), Q, t.size)
# offset_plan through StackingOffset("jax"), doomed services included
for i in range(5):
    K = int(rng.integers(2, 9))
    t = rng.uniform(-0.5, 6.0, size=K)
    offs = rng.integers(0, 9, size=K)
    s, tp = svcs(t)
    oq = _OffsetQuality(Q, offs.tolist())
    oq.refresh_doomed(s, tp)
    plan = StackingOffset("jax").plan(s, tp, D, Q, offs.tolist())
    out[f"offset_taus_{i}"], out[f"offset_offs_{i}"] = t, offs
    out[f"offset_fid_{i}"] = fid(plan, oq, K)
# the exact DP
for i in range(4):
    t = rng.uniform(0.1, 3.0, size=int(rng.integers(1, 7)))
    s, tp = svcs(t)
    out[f"optimal_taus_{i}"] = t
    out[f"optimal_fid_{i}"] = fid(optimal_plan(s, tp, D, Q, engine="jax"),
                                  Q, t.size)
    out[f"optimal_bound_{i}"] = optimal_mean_fid(list(t), D, Q,
                                                 engine="jax")
# plan_many (ragged through valid) and replan_many (offsets, doomed)
pm = rng.uniform(0.2, 5.0, size=(48, 8))
valid = np.ones(pm.shape, dtype=bool)
valid[::5, 5:] = False
res = jaxplan.plan_many(pm, delay=D, quality=Q, valid=valid)
out.update(pm_taus=pm, pm_valid=valid, pm_fid=res.mean_fid,
           pm_level=res.best_level, pm_steps=res.steps,
           pm_makespan=res.makespan)
rt = rng.uniform(-1.0, 6.0, size=(32, 8))
ro = rng.integers(0, 9, size=(32, 8))
rd = (ro > 0) & (rt < 0)
res = jaxplan.replan_many(rt, delay=D, quality=Q, offsets=ro, doomed=rd)
out.update(rm_taus=rt, rm_offs=ro, rm_doomed=rd, rm_fid=res.mean_fid,
           rm_steps=res.steps)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jaxplan") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    env.pop("REPRO_PLANNER_ENGINE", None)
    proc = subprocess.run([sys.executable, "-c", CHILD, str(path)],
                          capture_output=True, text=True, timeout=600,
                          cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        data = dict(z)
    with device_scope("cpu"):
        yield data


def _svcs(taus):
    return ([ServiceRequest(id=i, deadline=float(t), spectral_eff=7.0)
             for i, t in enumerate(taus)],
            {i: float(t) for i, t in enumerate(taus)})


def _fid(plan, q, K):
    return q.mean_fid([plan.steps_completed[k] for k in range(K)])


def _count(ref, prefix):
    return sum(1 for k in ref if k.startswith(prefix))


@pytest.mark.parametrize("entry", ["stacking", "equal_steps"])
def test_static_searches(ref, entry):
    n = _count(ref, "stacking_taus_")
    assert n == 8
    for i in range(n):
        taus = ref[f"stacking_taus_{i}"]
        svcs, tp = _svcs(taus)
        if entry == "stacking":
            plan = stacking(svcs, tp, DELAY, QUALITY, engine="torch")
        else:
            with arrays.engine_scope("torch"):
                plan = equal_steps(svcs, tp, DELAY, QUALITY)
        assert abs(_fid(plan, QUALITY, taus.size)
                   - float(ref[f"{entry}_fid_{i}"])) < TOL
        plan.validate(gen_deadlines=tp)


def test_offset_plan(ref):
    n = _count(ref, "offset_taus_")
    assert n == 5
    for i in range(n):
        taus, offs = ref[f"offset_taus_{i}"], ref[f"offset_offs_{i}"]
        svcs, tp = _svcs(taus)
        oq = _OffsetQuality(QUALITY, offs.tolist())
        oq.refresh_doomed(svcs, tp)
        plan = StackingOffset("torch").plan(svcs, tp, DELAY, QUALITY,
                                            offs.tolist())
        assert abs(_fid(plan, oq, taus.size)
                   - float(ref[f"offset_fid_{i}"])) < TOL
        plan.validate(gen_deadlines=tp)


def test_optimal_plan(ref):
    n = _count(ref, "optimal_taus_")
    assert n == 4
    for i in range(n):
        taus = ref[f"optimal_taus_{i}"]
        svcs, tp = _svcs(taus)
        plan = optimal.optimal_plan(svcs, tp, DELAY, QUALITY,
                                    engine="torch")
        assert abs(_fid(plan, QUALITY, taus.size)
                   - float(ref[f"optimal_fid_{i}"])) < TOL
        assert abs(optimal.optimal_mean_fid(list(taus), DELAY, QUALITY,
                                            engine="torch")
                   - float(ref[f"optimal_bound_{i}"])) < TOL
        plan.validate(gen_deadlines=tp)


def test_plan_many(ref):
    res = plan_many(ref["pm_taus"], delay=DELAY, quality=QUALITY,
                    valid=ref["pm_valid"])
    np.testing.assert_allclose(res.mean_fid, ref["pm_fid"], rtol=0,
                               atol=TOL)
    # the winners materialize through the exact pass into valid plans
    for s in range(0, res.num_scenarios, 6):
        K = int(ref["pm_valid"][s].sum())
        _, tp = _svcs(ref["pm_taus"][s][:K])
        plan = arrays.stacking_pass_vec(list(range(K)), tp, DELAY,
                                        int(res.best_level[s]))
        assert [plan.steps_completed[k] for k in range(K)] == \
            res.steps[s, :K].tolist()
        plan.validate(gen_deadlines=tp)


def test_replan_many(ref):
    res = replan_many(ref["rm_taus"], delay=DELAY, quality=QUALITY,
                      offsets=ref["rm_offs"], doomed=ref["rm_doomed"])
    assert ref["rm_doomed"].any()
    np.testing.assert_allclose(res.mean_fid, ref["rm_fid"], rtol=0,
                               atol=TOL)
