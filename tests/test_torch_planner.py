"""The port's planner against ``repro``'s: the NumPy copies
(``repro_torch.core.{arrays,stacking,baselines,offset,optimal}``) held
``==`` to the reference on the scalar and vec engines, plan for plan, on
the instances of tests/test_arrays.py, test_offset.py and
test_stacking.py; the engine registry, the ``SCHEDULERS`` table and the
``engine=`` plumbing of ``Provisioner``, ``ExecutionLoop`` and
``simulate_online``; and the device engine ``repro_torch.core.torchplan``
on the CPU (``device_scope("cpu")``) within 1e-9 mean FID of the port's
vec engine.  tests/test_torch_planner_jax.py holds the device engine to
the reference's jax engine; tests/test_torch_planner_properties.py has
the hypothesis properties."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api.schedulers import equal_steps as jax_equal_steps  # noqa: E402
from repro.core import arrays as jarrays  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import offset as joffset  # noqa: E402
from repro.core import optimal as joptimal  # noqa: E402
from repro.core import service as jsvc  # noqa: E402
from repro.core import stacking as jstacking  # noqa: E402
from repro.core.delay_model import DelayModel as JaxDelay  # noqa: E402
from repro.core.quality_model import PowerLawFID as JaxFID  # noqa: E402
from repro_torch.api import SCHEDULERS, Provisioner  # noqa: E402
from repro_torch.api.provisioner import ALLOCATORS  # noqa: E402
from repro_torch.api.schedulers import equal_steps  # noqa: E402
from repro_torch.core import arrays, baselines, offset, optimal  # noqa: E402
from repro_torch.core import service as psvc  # noqa: E402
from repro_torch.core import stacking as pstacking  # noqa: E402
from repro_torch.core import torchplan  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.online import _OffsetQuality  # noqa: E402
from repro_torch.core.online import simulate_online  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.torchplan import device_scope, kernels  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
DELAY, QUALITY = DelayModel(), PowerLawFID()
JDELAY, JQUALITY = JaxDelay(), JaxFID()
TOL = 1e-9          # the device engine's contract: mean FID


def same(a, b):
    """Two plans (of either package) equal field for field."""
    assert a.batches == b.batches
    assert a.start_times == b.start_times
    assert a.steps_completed == b.steps_completed
    assert a.makespan() == b.makespan()


def pair(**kw):
    """The same scenario from both packages' make_scenario."""
    return jsvc.make_scenario(**kw), psvc.make_scenario(**kw)


def services(taus):
    """ServiceRequests of both packages for budgets ``taus``, and tau'."""
    return ([jsvc.ServiceRequest(id=i, deadline=float(t), spectral_eff=7.0)
             for i, t in enumerate(taus)],
            [psvc.ServiceRequest(id=i, deadline=float(t), spectral_eff=7.0)
             for i, t in enumerate(taus)],
            {i: float(t) for i, t in enumerate(taus)})


def tau_prime(scn, slack):
    return {s.id: s.deadline - slack for s in scn.services}


def mean_fid(plan, ids, quality=QUALITY):
    return quality.mean_fid([plan.steps_completed[k] for k in ids])


# ---------------------------------------------------------------------------
# The NumPy copies, == to the reference
# ---------------------------------------------------------------------------

class TestCopies:
    @pytest.mark.parametrize("K", [1, 3, 8, 20])
    def test_stacking_pass_both_engines(self, K):
        rng = np.random.default_rng(K)
        for seed in range(4):
            js, ps = pair(K=K, seed=seed)
            tp = tau_prime(js, float(rng.uniform(0, 2)))
            ids = [s.id for s in js.services]
            off = {k: int(rng.integers(0, 9)) for k in ids}
            for t_star in (0, 1, 2, 5, 13, 40):
                for o in (None, off):
                    want = jstacking.stacking_pass(ids, tp, JDELAY, t_star,
                                                   offsets=o)
                    same(pstacking.stacking_pass(ids, tp, DELAY, t_star,
                                                 offsets=o), want)
                    same(arrays.stacking_pass_vec(ids, tp, DELAY, t_star,
                                                  offsets=o), want)

    def test_equal_deadline_ties_and_empty(self):
        for taus in ([10.0] * 8, [3.0, 3.0, 3.0, 15.0], [5.0] * 6):
            tp = {i: t for i, t in enumerate(taus)}
            for t_star in (1, 3, 9):
                same(arrays.stacking_pass_vec(list(tp), tp, DELAY, t_star),
                     jstacking.stacking_pass(list(tp), tp, JDELAY, t_star))
        same(arrays.stacking_pass_vec([], {}, DELAY, 1),
             jarrays.stacking_pass_vec([], {}, JDELAY, 1))

    def test_offset_pass_and_sweeps(self):
        rng = np.random.default_rng(2)
        for seed in range(4):
            js, _ = pair(K=9, tau_min=2.0, tau_max=8.0, seed=seed)
            tp = tau_prime(js, 0.4)
            ids = [s.id for s in js.services]
            targets = {k: int(rng.integers(0, 12)) for k in ids}
            want = joffset.offset_pass(ids, tp, JDELAY, targets)
            same(offset.offset_pass(ids, tp, DELAY, targets), want)
            same(arrays.offset_pass_vec(ids, tp, DELAY, targets), want)
        js, _ = pair(K=12, seed=3)
        tp = tau_prime(js, 0.6)
        ids = [s.id for s in js.services]
        off = {k: k % 4 for k in ids}
        levels = list(range(1, 31))
        arr, jarr = (arrays.ServiceArrays.build(ids, tp, off),
                     jarrays.ServiceArrays.build(ids, tp, off))
        for got, want in zip(arrays.sweep_clustered(arr, DELAY, levels),
                             jarrays.sweep_clustered(jarr, JDELAY, levels)):
            np.testing.assert_array_equal(got, want)
        targets = np.maximum(np.asarray(levels)[:, None] - arr.offsets, 0)
        for got, want in zip(arrays.sweep_lockstep(arr, DELAY, targets),
                             jarrays.sweep_lockstep(jarr, JDELAY, targets)):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("engine", ["scalar", "vec"])
    def test_stacking_search(self, engine):
        for seed in range(4):
            for K in (1, 4, 12, 24):
                js, ps = pair(K=K, seed=seed)
                same(pstacking.stacking(ps.services, tau_prime(ps, 0.7),
                                        DELAY, QUALITY, engine=engine),
                     jstacking.stacking(js.services, tau_prime(js, 0.7),
                                        JDELAY, JQUALITY, engine="scalar"))

    @pytest.mark.parametrize("engine", ["scalar", "vec"])
    def test_equal_steps(self, engine):
        for seed in range(4):
            js, ps = pair(K=9, seed=seed)
            with jarrays.engine_scope("scalar"):
                want = jax_equal_steps(js.services, tau_prime(js, 0.8),
                                       JDELAY, JQUALITY)
            with arrays.engine_scope(engine):
                same(equal_steps(ps.services, tau_prime(ps, 0.8), DELAY,
                                 QUALITY), want)

    @pytest.mark.parametrize("name", ["single_instance", "greedy_batching",
                                      "fixed_size_batching"])
    def test_baselines(self, name):
        for seed in range(4):
            for kw in (dict(K=12, seed=seed),
                       dict(K=6, tau_min=0.05, tau_max=2.5, seed=seed)):
                js, ps = pair(**kw)
                same(getattr(baselines, name)(ps.services,
                                              tau_prime(ps, 1.0), DELAY,
                                              QUALITY),
                     getattr(jbase, name)(js.services, tau_prime(js, 1.0),
                                          JDELAY, JQUALITY))

    @pytest.mark.parametrize("engine", ["scalar", "vec"])
    def test_offset_plans_with_progress(self, engine):
        rng = np.random.default_rng(5)
        for seed in range(3):
            for K in (1, 2, 5, 12):
                for window in ((3.0, 8.0), (0.3, 2.0), (7.0, 20.0)):
                    js, ps = pair(K=K, tau_min=window[0],
                                  tau_max=window[1], seed=seed)
                    slack = float(rng.uniform(0, 1.5))
                    offs = [int(x) for x in rng.integers(0, 9, K)]
                    same(offset.StackingOffset(engine).plan(
                        ps.services, tau_prime(ps, slack), DELAY, QUALITY,
                        offs),
                        joffset.StackingOffset("scalar").plan(
                            js.services, tau_prime(js, slack), JDELAY,
                            JQUALITY, offs))

    @pytest.mark.parametrize("engine", ["scalar", "vec"])
    def test_offset_doomed_and_zero_offsets(self, engine):
        js, ps = pair(K=5, tau_min=3.0, tau_max=8.0, seed=6)
        jtp, ptp = tau_prime(js, 0.5), tau_prime(ps, 0.5)
        jtp[0] = ptp[0] = -0.5
        offs = [3, 0, 2, 0, 1]
        same(offset.StackingOffset(engine).plan(ps.services, ptp, DELAY,
                                                QUALITY, offs),
             joffset.StackingOffset("scalar").plan(js.services, jtp, JDELAY,
                                                   JQUALITY, offs))
        js, ps = pair(K=8, seed=7)
        same(offset.StackingOffset(engine)(ps.services, tau_prime(ps, 0.6),
                                           DELAY, QUALITY),
             jstacking.stacking(js.services, tau_prime(js, 0.6), JDELAY,
                                JQUALITY, engine="scalar"))

    def test_optimal(self):
        rng = np.random.default_rng(5)
        for K in (1, 2, 3, 4, 5, 6):
            taus = rng.uniform(0.1, 3.0, size=K)
            jsv, psv, tp = services(taus)
            assert optimal.optimal_mean_fid(list(tp.values()), DELAY,
                                            QUALITY) == \
                joptimal.optimal_mean_fid(list(tp.values()), JDELAY,
                                          JQUALITY)
            same(optimal.optimal_plan(psv, tp, DELAY, QUALITY),
                 joptimal.optimal_plan(jsv, tp, JDELAY, JQUALITY))
        jsv, psv, tp = services(np.full(9, 2.0))
        with pytest.raises(AssertionError):
            optimal.optimal_plan(psv, tp, DELAY, QUALITY)

    def test_first_best_and_score_rows(self):
        rows = np.random.default_rng(4).integers(0, 6, (40, 5))
        rows[7] = rows[3]
        assert arrays.first_best(rows, QUALITY) == \
            jarrays.first_best(rows, JQUALITY)
        np.testing.assert_array_equal(arrays.score_rows(rows, QUALITY),
                                      jarrays.score_rows(rows, JQUALITY))


# ---------------------------------------------------------------------------
# Engines, schedulers and the engine= plumbing
# ---------------------------------------------------------------------------

def _child(code, **env):
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, cwd=ROOT, env=dict(os.environ, PYTHONPATH="src", **env))


class TestEngines:
    def test_default_scope_and_errors(self):
        assert arrays.get_engine() == "vec"
        with arrays.engine_scope("torch"):
            assert arrays.get_engine() == "torch"
            with arrays.engine_scope(None):
                assert arrays.get_engine() == "torch"
        assert arrays.get_engine() == "vec"
        assert arrays.engine_impl("torch") is torchplan.IMPL
        assert {"scalar", "torch", "vec"} <= set(arrays.registered_engines())
        for bad in ("jax", "gpu"):
            with pytest.raises(ValueError, match="torch"):
                arrays.set_engine(bad)
        with pytest.raises(ValueError):
            pstacking.stacking(psvc.make_scenario(K=2, seed=0).services,
                               {0: 5.0, 1: 5.0}, DELAY, QUALITY,
                               engine="nope")

    def test_env_var_sets_the_process_default(self):
        out = _child("from repro_torch.core import arrays; "
                     "print(arrays.get_engine())",
                     REPRO_PLANNER_ENGINE="torch")
        assert out.stdout.strip() == "torch", out.stderr
        out = _child("import repro_torch.core.arrays",
                     REPRO_PLANNER_ENGINE="typo")
        assert out.returncode != 0
        assert "REPRO_PLANNER_ENGINE" in out.stderr

    def test_schedulers_carry_the_reference_names(self):
        out = _child("import json, repro.api; "
                     "from repro.api.registry import SCHEDULERS; "
                     "print(json.dumps(SCHEDULERS.names()))",
                     JAX_PLATFORMS="cpu")
        assert out.returncode == 0, out.stderr
        want = {n.replace("_jax", "_torch")
                for n in json.loads(out.stdout)}
        assert set(SCHEDULERS.names()) == want
        for name, alias in (("fixed_size", "fixed"),
                            ("single_instance", "single"),
                            ("stacking_offset", "offset"),
                            ("stacking_offset_scalar", "offset_scalar"),
                            ("stacking_offset_torch", "offset_torch")):
            assert SCHEDULERS.get(name) is SCHEDULERS.get(alias)
        assert SCHEDULERS.get("stacking_offset_torch").engine == "torch"
        assert SCHEDULERS.get("stacking_offset") is offset.stacking_offset

    @pytest.mark.parametrize("name", ["greedy", "fixed_size",
                                      "single_instance", "optimal",
                                      "stacking_offset", "stacking_scalar",
                                      "equal_steps"])
    def test_provisioner_schedulers_match_reference(self, name):
        from repro.api import Provisioner as JaxProvisioner
        kw = dict(K=5, tau_min=1.0, tau_max=3.0, seed=3)
        ref = JaxProvisioner(jsvc.make_scenario(**kw), scheduler=name,
                             allocator="inv_se").run()
        got = Provisioner(psvc.make_scenario(**kw), scheduler=name,
                          allocator="inv_se").run()
        same(got.plan, ref.plan)
        assert got.mean_fid == ref.mean_fid


# ---------------------------------------------------------------------------
# The device engine on the CPU, against the port's vec engine
# ---------------------------------------------------------------------------

@pytest.fixture
def on_cpu():
    with device_scope("cpu"):
        yield


def _oq(offs, svcs, tp):
    oq = _OffsetQuality(QUALITY, list(offs))
    oq.refresh_doomed(svcs, tp)
    return oq


@pytest.mark.usefixtures("on_cpu")
class TestTorchEngine:
    def test_stacking_and_equal_steps(self):
        rng = np.random.default_rng(0)
        for _ in range(6):
            K = int(rng.integers(1, 14))
            _, svcs, tp = services(rng.uniform(0.1, 6.0, size=K))
            for fn in (pstacking.stacking, equal_steps):
                with arrays.engine_scope("vec"):
                    pv = fn(svcs, tp, DELAY, QUALITY)
                with arrays.engine_scope("torch"):
                    pt = fn(svcs, tp, DELAY, QUALITY)
                assert abs(mean_fid(pv, range(K))
                           - mean_fid(pt, range(K))) < TOL
                pt.validate(gen_deadlines=tp)
        scn = psvc.make_scenario(K=10, tau_min=2.0, tau_max=6.0, seed=1)
        tp = {s.id: s.deadline * 0.4 for s in scn.services}
        ids = [s.id for s in scn.services]
        assert abs(mean_fid(SCHEDULERS.get("stacking")(scn.services, tp, DELAY,
                                                   QUALITY), ids)
                   - mean_fid(SCHEDULERS.get("stacking_torch")(
                       scn.services, tp, DELAY, QUALITY), ids)) < TOL

    def test_custom_quality_scores_on_the_host(self):
        """A quality model other than a bare PowerLawFID goes through
        its own mean_fid, as in the reference's backend."""
        q = _OffsetQuality(QUALITY, [2, 0, 5, 1])
        _, svcs, tp = services([2.5, 3.0, 1.0, 4.0])
        pv = pstacking.stacking(svcs, tp, DELAY, q, engine="vec")
        pt = pstacking.stacking(svcs, tp, DELAY, q, engine="torch")
        assert abs(mean_fid(pv, range(4), q) - mean_fid(pt, range(4), q)) \
            < TOL

    def test_offset_plans(self):
        sv, st = offset.StackingOffset("vec"), offset.StackingOffset("torch")
        rng = np.random.default_rng(3)
        for _ in range(4):
            K = int(rng.integers(2, 10))
            _, svcs, tp = services(rng.uniform(0.3, 6.0, size=K))
            offs = [int(x) for x in rng.integers(0, 9, K)]
            oq = _oq(offs, svcs, tp)
            pv = sv.plan(svcs, tp, DELAY, QUALITY, offs)
            pt = st.plan(svcs, tp, DELAY, QUALITY, offs)
            assert abs(mean_fid(pv, range(K), oq)
                       - mean_fid(pt, range(K), oq)) < TOL
            pt.validate(gen_deadlines=tp)
        scn = psvc.make_scenario(K=5, tau_min=3.0, tau_max=8.0, seed=6)
        tp = {s.id: s.deadline * 0.1 for s in scn.services}
        tp[0] = -0.5
        offs = [3, 0, 2, 0, 1]
        oq = _oq(offs, scn.services, tp)
        ids = [s.id for s in scn.services]
        assert abs(mean_fid(sv.plan(scn.services, tp, DELAY, QUALITY, offs),
                            ids, oq)
                   - mean_fid(st.plan(scn.services, tp, DELAY, QUALITY,
                                      offs), ids, oq)) < TOL
        scn = psvc.make_scenario(K=8, tau_min=2.0, tau_max=6.0, seed=7)
        tp = {s.id: s.deadline * 0.5 for s in scn.services}
        assert st(scn.services, tp, DELAY, QUALITY).steps_completed == \
            pstacking.stacking(scn.services, tp, DELAY, QUALITY,
                               engine="torch").steps_completed

    def test_optimal(self):
        rng = np.random.default_rng(6)
        for _ in range(4):
            K = int(rng.integers(1, 7))
            _, svcs, tp = services(rng.uniform(0.1, 3.0, size=K))
            bound = optimal.optimal_mean_fid(list(tp.values()), DELAY,
                                             QUALITY)
            assert abs(optimal.optimal_mean_fid(
                list(tp.values()), DELAY, QUALITY, engine="torch")
                - bound) < TOL
            plan = optimal.optimal_plan(svcs, tp, DELAY, QUALITY,
                                        engine="torch")
            assert abs(mean_fid(plan, range(K)) - bound) < TOL
            plan.validate(gen_deadlines=tp)
        _, svcs, tp = services(np.full(9, 2.0))
        with pytest.raises(AssertionError):
            optimal.optimal_plan(svcs, tp, DELAY, QUALITY, engine="torch")

    def test_plan_many(self):
        S, K = 64, 8
        taus = np.random.default_rng(7).uniform(0.2, 5.0, size=(S, K))
        res = torchplan.plan_many(taus, delay=DELAY, quality=QUALITY)
        assert res.num_scenarios == S
        for s in range(0, S, 7):
            _, svcs, tp = services(taus[s])
            pv = arrays.stacking_vec(svcs, tp, DELAY, QUALITY)
            assert abs(mean_fid(pv, range(K)) - res.mean_fid[s]) < TOL
            plan = arrays.stacking_pass_vec(list(range(K)), tp, DELAY,
                                            int(res.best_level[s]))
            assert [plan.steps_completed[k] for k in range(K)] == \
                res.steps[s].tolist()
            assert plan.makespan() == res.makespan[s]
            plan.validate(gen_deadlines=tp)

    def test_plan_many_ragged_offsets_and_errors(self):
        taus = np.array([[2.0, 3.0, 1.5, 2.5, 4.0],
                         [2.0, 3.0, 1.5, 0.0, 0.0]])
        valid = np.array([[True] * 5, [True, True, True, False, False]])
        res = torchplan.plan_many(taus, delay=DELAY, quality=QUALITY,
                                  valid=valid)
        _, svcs, tp = services(taus[1][:3])
        pv = arrays.stacking_vec(svcs, tp, DELAY, QUALITY)
        assert abs(mean_fid(pv, range(3)) - res.mean_fid[1]) < TOL
        assert (res.steps[1, 3:] == 0).all()
        off = np.zeros((4, 5), dtype=np.int64)
        off[2:] = 4
        res = torchplan.plan_many(np.full((4, 5), 3.0), delay=DELAY,
                                  quality=QUALITY, offsets=off)
        assert res.mean_fid[2] < res.mean_fid[0] - 1e-6
        with pytest.raises(TypeError, match="PowerLawFID"):
            torchplan.plan_many(np.ones((2, 3)), delay=DELAY,
                                quality=_OffsetQuality(QUALITY, [0] * 3))
        # devices= shards the scenario axis (two CPU "devices" here) with
        # the unsharded results; more devices than there are raise
        for fn in (torchplan.plan_many, torchplan.replan_many):
            one = fn(taus, delay=DELAY, quality=QUALITY, valid=valid)
            two = fn(taus, delay=DELAY, quality=QUALITY, valid=valid,
                     devices=2)
            for field in ("best_level", "steps", "mean_fid", "makespan"):
                assert np.array_equal(getattr(one, field),
                                      getattr(two, field))
            with pytest.raises(ValueError, match="devices=100000"):
                fn(taus, delay=DELAY, quality=QUALITY, devices=100000)

    def test_replan_many_matches_the_vec_residual_replan(self):
        rng = np.random.default_rng(11)
        S, K = 24, 7
        taus = rng.uniform(-1.0, 6.0, size=(S, K))
        offs = rng.integers(0, 9, size=(S, K))
        doomed = (offs > 0) & (taus < 0)
        res = torchplan.replan_many(taus, delay=DELAY, quality=QUALITY,
                                    offsets=offs, doomed=doomed)
        for s in range(S):
            _, svcs, tp = services(taus[s])
            oq = _oq(offs[s], svcs, tp)
            pv = pstacking.stacking(svcs, tp, DELAY, oq, engine="vec")
            assert abs(mean_fid(pv, range(K), oq) - res.mean_fid[s]) < TOL
        zero = torchplan.replan_many(taus[:4], delay=DELAY, quality=QUALITY)
        plain = torchplan.plan_many(taus[:4], delay=DELAY, quality=QUALITY)
        np.testing.assert_allclose(zero.mean_fid, plain.mean_fid,
                                   rtol=0, atol=TOL)

    @pytest.mark.parametrize("name", ["stacking", "stacking_offset"])
    def test_simulate_online(self, name):
        sched = SCHEDULERS.get(name)
        for seed in range(2):
            scn = psvc.make_scenario(K=9, tau_min=3.0, tau_max=8.0,
                                     arrival_rate=1.0, seed=seed)
            rv = simulate_online(scn, sched, ALLOCATORS.get("inv_se"),
                                 engine="vec")
            rt = simulate_online(scn, sched, ALLOCATORS.get("inv_se"),
                                 engine="torch")
            assert abs(rv.mean_fid - rt.mean_fid) < TOL

    def test_provisioner_closed_loop(self):
        """The chip_smoke.py phase plan check, on the CPU."""
        out = []
        for engine in ("vec", "torch"):
            out.append(Provisioner(
                psvc.make_scenario(K=8, seed=0), scheduler="stacking_offset",
                allocator="inv_se", delay=DelayModel(0.012, 0.17715),
                engine=engine, device="cpu", execute_kwargs=dict(
                    executor="simulated", min_batches=2, drift_tol=0.2,
                    executor_kwargs={"true_delay": DELAY})).run(
                        execute="closed"))
        v, t = out
        assert t.execution.replans == v.execution.replans > 0
        assert t.plan.batches == v.plan.batches
        assert t.execution.executed_log == v.execution.executed_log
        assert abs(v.mean_fid - t.mean_fid) < TOL
        assert abs(v.execution.mean_fid - t.execution.mean_fid) < TOL


def test_torch_engine_needs_a_card_or_a_cpu_request():
    """Without a card the device engine raises unless the CPU is asked
    for; it never carries on on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, svcs, tp = services([2.0, 3.0])
    with pytest.raises(RuntimeError, match="cuda"):
        pstacking.stacking(svcs, tp, DELAY, QUALITY, engine="torch")
    with pytest.raises(RuntimeError, match="cuda"):
        torchplan.plan_many(np.ones((2, 3)), delay=DELAY, quality=QUALITY)
    with pytest.raises(RuntimeError, match="cuda"):
        Provisioner(psvc.make_scenario(K=3, seed=0), allocator="inv_se",
                    engine="torch").run()
    with pytest.raises(RuntimeError, match="cuda"):
        simulate_online(psvc.make_scenario(K=3, seed=0), pstacking.stacking,
                        ALLOCATORS.get("inv_se"), engine="torch")
    with device_scope("cpu"):
        res = torchplan.plan_many(np.ones((2, 3)), delay=DELAY,
                                  quality=QUALITY)
    assert res.num_scenarios == 2


@pytest.mark.usefixtures("on_cpu")
def test_sweeps_equal_the_vec_sweeps_exactly():
    """The device sweeps do the vec sweeps' float64 operations in the
    same order, so counts and makespans come out equal, on the paper's
    model and on one with a < 0, where the drop loop runs to its fixed
    point with checks."""
    for delay in (DELAY, DelayModel(a=-0.03, b=0.4)):
        for seed in range(3):
            scn = psvc.make_scenario(K=17, seed=seed)
            tp = {s.id: s.deadline * 0.3 for s in scn.services}
            ids = [s.id for s in scn.services]
            off = {k: k % 5 for k in ids}
            arr = arrays.ServiceArrays.build(ids, tp, off)
            levels = np.arange(1, 40)
            want = arrays.sweep_clustered(arr, delay, levels)
            got = kernels.clustered_counts(arr.tau_prime, arr.offsets,
                                           levels, delay, ids=arr.ids)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            targets = np.maximum(levels[:, None] - arr.offsets, 0)
            want = arrays.sweep_lockstep(arr, delay, targets)
            got = kernels.lockstep_counts(arr.tau_prime, targets, delay)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
