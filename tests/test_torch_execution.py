"""The port's closed execution loop (``repro_torch.core.execution``,
``core.online``, ``api.execution``, ``Provisioner.run(execute=...)``)
against ``repro``'s on the simulated executor and on the same
scenarios.  Everything here is NumPy arithmetic in the same order as the
reference, so every result is held equal (``==``): refits, batch
records, replans, executed logs, FID, outage, ``to_dict()`` and the
online simulator's event sequences.  Mirrors tests/test_execution.py."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.api import Provisioner as JaxProvisioner  # noqa: E402
from repro.api import execute_report as jax_execute_report  # noqa: E402
from repro.api.execution import replay_plan as jax_replay_plan  # noqa: E402
from repro.api.execution import replay_result as jax_replay_result  # noqa: E402
from repro.core import delay_model as jd  # noqa: E402
from repro.core import execution as jex  # noqa: E402
from repro.core import online as jon  # noqa: E402
from repro.core import service as js  # noqa: E402
from repro.core.bandwidth import inv_se_allocate as jax_inv_se  # noqa: E402
from repro.core.bandwidth import pso_allocate as jax_pso  # noqa: E402
from repro.core.quality_model import PowerLawFID as JaxFID  # noqa: E402
from repro.core.stacking import stacking as jax_stacking  # noqa: E402
from repro_torch.api import (EXECUTORS, ExecutionResult,  # noqa: E402
                             Provisioner, execute_plan, execute_report)
from repro_torch.api.execution import (replay_plan,  # noqa: E402
                                       replay_result, with_kwargs)
from repro_torch.api.provisioner import ALLOCATORS  # noqa: E402
from repro_torch.core import delay_model as pd  # noqa: E402
from repro_torch.core import execution as pex  # noqa: E402
from repro_torch.core import online as pon  # noqa: E402
from repro_torch.core import service as ps  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.core.torchplan import device_scope  # noqa: E402

TRUE, HALF = (0.1, 0.2), (0.05, 0.1)   # the planner's 2x-fast misestimate
NOISE = [{}, {"noise": 0.1, "seed": 7}]


def _kw(delay, true=TRUE, **extra):
    """The reference test's loop settings, for either package."""
    return {"executor": "simulated",
            "executor_kwargs": dict({"true_delay": delay(*true)}, **extra),
            "min_batches": 2, "drift_tol": 0.2}


def _pair(scn_kw, delay=HALF, noise=None, **run_kw):
    """The same closed-loop Provisioner run in both packages."""
    ref = JaxProvisioner(js.make_scenario(**scn_kw), scheduler="stacking",
                         allocator="inv_se", delay=jd.DelayModel(*delay),
                         execute_kwargs=_kw(jd.DelayModel,
                                            **(noise or {}))).run(**run_kw)
    got = Provisioner(ps.make_scenario(**scn_kw), scheduler="stacking",
                      allocator="inv_se", delay=pd.DelayModel(*delay),
                      execute_kwargs=_kw(pd.DelayModel,
                                         **(noise or {}))).run(**run_kw)
    return ref, got


def _same_execution(ref, got):
    assert [dataclasses.astuple(r) for r in got.records] == \
        [dataclasses.astuple(r) for r in ref.records]
    assert [dataclasses.astuple(o) for o in got.outcomes] == \
        [dataclasses.astuple(o) for o in ref.outcomes]
    assert got.executed_log == ref.executed_log
    assert got.content == ref.content
    assert (got.delay.a, got.delay.b) == (ref.delay.a, ref.delay.b)
    assert (got.replans, got.refits, got.mode) == \
        (ref.replans, ref.refits, ref.mode)
    assert (got.mean_fid, got.outage_rate, got.delivered_fid,
            got.wall_clock) == (ref.mean_fid, ref.outage_rate,
                                ref.delivered_fid, ref.wall_clock)
    assert got.per_bucket() == ref.per_bucket()
    assert got.predicted_wall() == ref.predicted_wall()
    assert got.to_dict() == ref.to_dict()
    assert got.summary() == ref.summary()


class TestDelayRefit:
    @pytest.mark.parametrize("sizes, delays", [
        ([1, 2, 4, 8], [0.3, 0.4, 0.6, 1.0]),        # exact affine
        ([4, 4], [1.2, 1.2]),                        # one size: rescale
        ([1, 3, 3, 8, 2], [0.31, 0.52, 0.49, 0.97, 0.43]),
        ([5, 1], [0.1, 0.9]),                        # negative slope: floor
        ([2, 2, 2], [0.05, 0.07, 0.06]),
    ])
    def test_refit_equal(self, sizes, delays):
        ref = jd.DelayModel(a=0.1, b=0.2).refit(sizes, delays)
        got = pd.DelayModel(a=0.1, b=0.2).refit(sizes, delays)
        assert (got.a, got.b) == (ref.a, ref.b)

    @pytest.mark.parametrize("sizes, delays", [([], []), ([1, 2], [0.1])])
    def test_refit_rejects_empty_and_mismatch(self, sizes, delays):
        for m in (jd.DelayModel(), pd.DelayModel()):
            with pytest.raises(ValueError):
                m.refit(sizes, delays)

    def test_fit_needs_two_points(self):
        with pytest.raises(ValueError):
            pd.fit([1], [0.1])

    def test_rolling_fit_equal(self):
        ref = jd.RollingDelayFit(window=4, prior=jd.DelayModel(*HALF))
        got = pd.RollingDelayFit(window=4, prior=pd.DelayModel(*HALF))
        for fit in (ref, got):
            assert not fit.ready
        assert got.model().g(2) == ref.model().g(2)
        for x, s in [(1, 0.31), (2, 0.39), (3, 0.52), (4, 0.58),
                     (5, 0.71)]:
            ref.observe(x, s)
            got.observe(x, s)
            assert len(got) == len(ref) and got.ready == ref.ready
            for h in (1.0, 1.5):
                m, r = got.model(headroom=h), ref.model(headroom=h)
                assert (m.a, m.b) == (r.a, r.b)
        assert len(got) == 4
        with pytest.raises(ValueError, match="window"):
            pd.RollingDelayFit(window=1)


class TestSimulatedSession:
    def _plan(self, K):
        return Provisioner(ps.make_scenario(K=K, seed=0), allocator="inv_se",
                           delay=pd.DelayModel(*HALF)).run(execute=False).plan

    def test_runs_and_credits(self):
        plan = self._plan(3)
        sess = pex.SimulatedSession(plan, pd.DelayModel(*TRUE))
        batch = [k for k, _ in plan.batches[0]]
        assert sess.run_batch(batch, timed=True) == \
            pd.DelayModel(*TRUE).g(len(batch))
        assert all(sess.steps_done[k] == 1 for k in batch)
        assert sess.telemetry() == {"exec_engine": "simulated"}

    def test_noise_draws_equal(self):
        plan = self._plan(4)
        ref = jex.SimulatedSession(plan, jd.DelayModel(*TRUE), noise=0.2,
                                   seed=3)
        got = pex.SimulatedSession(plan, pd.DelayModel(*TRUE), noise=0.2,
                                   seed=3)
        for batch in plan.batches:
            ks = [k for k, _ in batch]
            assert got.run_batch(ks) == ref.run_batch(ks)
        assert got.finish() == ref.finish()

    def test_exhausted_steps_raise(self):
        plan = self._plan(2)
        sess = pex.SimulatedSession(plan, pd.DelayModel(*TRUE))
        k = next(iter(plan.steps_completed))
        for _ in range(plan.steps_completed[k]):
            sess.run_batch([k])
        with pytest.raises(ValueError, match="no remaining"):
            sess.run_batch([k])

    def test_retarget_no_resurrection(self):
        plan = self._plan(2)
        sess = pex.SimulatedSession(plan, pd.DelayModel(*TRUE))
        k = next(iter(plan.steps_completed))
        sess.run_batch([k])
        with pytest.raises(ValueError, match="retarget"):
            sess.retarget({k: 0})


class TestExecutionLoop:
    @pytest.mark.parametrize("noise", NOISE)
    @pytest.mark.parametrize("mode", ["open", "closed"])
    @pytest.mark.parametrize("scn_kw", [dict(K=5, seed=1),
                                        dict(K=6, seed=2),
                                        dict(K=5, seed=4)])
    def test_provisioner_run_equal(self, scn_kw, mode, noise):
        ref, got = _pair(scn_kw, noise=noise, execute=mode)
        assert got.plan.batches == ref.plan.batches
        assert got.mean_fid == ref.mean_fid
        assert got.timings == ref.timings
        _same_execution(ref.execution, got.execution)
        assert got.to_dict() == ref.to_dict()
        assert got.summary() == ref.summary()

    def test_closed_beats_open_under_misestimate(self):
        open_ex = _pair(dict(K=5, seed=1), execute="open")[1].execution
        closed_ex = _pair(dict(K=5, seed=1), execute="closed")[1].execution
        assert closed_ex.replans >= 1 and closed_ex.refits >= 1
        assert closed_ex.delivered_fid < open_ex.delivered_fid
        assert closed_ex.outage_rate < open_ex.outage_rate

    def test_no_drift_no_replan(self):
        ref, got = _pair(dict(K=5, seed=1), delay=TRUE, execute="closed")
        assert got.execution.replans == 0
        assert got.execution.outage_rate == 0.0
        _same_execution(ref.execution, got.execution)

    def test_executed_log_monotone_no_resurrection(self):
        ex = _pair(dict(K=6, seed=2), execute="closed")[1].execution
        assert ex.replans >= 1
        seen = {}
        for t, k, steps in ex.executed_log:
            assert steps == seen.get(k, 0) + 1    # one step per entry
            seen[k] = steps
        by_id = {o.id: o for o in ex.outcomes}
        assert ex.content == {k: by_id[k].steps for k in ex.content}
        times = [t for t, _, _ in ex.executed_log]
        assert times == sorted(times)

    def test_loop_direct_equal(self):
        """``ExecutionLoop`` built by hand, closed, with headroom and a
        small window, on both packages."""
        kw = dict(K=6, seed=9)
        out = []
        for pkg, dm, loop, sess, sched, alloc in (
                (js, jd, jex.ExecutionLoop, jex.SimulatedSession,
                 jax_stacking, lambda s, *_: jax_inv_se(s)),
                (ps, pd, pex.ExecutionLoop, pex.SimulatedSession,
                 stacking, ALLOCATORS.get("inv_se"))):
            scn = pkg.make_scenario(**kw)
            rep = (JaxProvisioner if pkg is js else Provisioner)(
                scn, allocator="inv_se",
                delay=dm.DelayModel(*HALF)).run(execute=False)
            out.append(loop(
                scn, rep.plan, rep.allocation,
                sess(rep.plan, dm.DelayModel(*TRUE), noise=0.05, seed=1),
                delay=dm.DelayModel(*HALF), scheduler=sched,
                allocator=alloc, mode="closed", window=4, drift_tol=0.1,
                min_batches=2, headroom=1.2).run())
        _same_execution(*out)

    def test_mode_validation(self):
        scn = ps.make_scenario(K=3, seed=0)
        with pytest.raises(ValueError, match="execute"):
            Provisioner(scn, allocator="inv_se").run(execute="sideways")
        with pytest.raises(ValueError, match="execute"):
            Provisioner(scn, execute="sideways")
        with pytest.raises(ValueError, match="refit"):
            Provisioner(scn, allocator="inv_se").run(refit=True)
        with pytest.raises(ValueError, match="mode"):
            pex.ExecutionLoop(scn, None, [], None, mode="sideways")

    def test_engine_beyond_scalar_raises(self):
        """Every engine the port has runs the loop and the online
        simulator; an engine it lacks (``"jax"``) raises, and so does
        ``"torch"`` with no card and no CPU request."""
        scn = ps.make_scenario(K=3, seed=0)
        rep = Provisioner(scn, allocator="inv_se",
                          delay=pd.DelayModel(*HALF)).run(execute=False)
        runs = {}
        for engine in ("scalar", "vec", "jax", "torch"):
            def closed():
                return execute_plan(scn, rep.plan, rep.allocation,
                                    executor="simulated", engine=engine,
                                    min_batches=2, drift_tol=0.2,
                                    delay=pd.DelayModel(*HALF),
                                    executor_kwargs={
                                        "true_delay": pd.DelayModel(*TRUE)})

            def online():
                return pon.simulate_online(scn, stacking,
                                           ALLOCATORS.get("inv_se"),
                                           engine=engine)
            if engine == "jax":
                with pytest.raises(ValueError, match="planner engine"):
                    closed()
                with pytest.raises(ValueError, match="planner engine"):
                    online()
                continue
            if engine == "torch" and not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="cuda"):
                    closed()
                with pytest.raises(RuntimeError, match="cuda"):
                    online()
                with device_scope("cpu"):
                    runs[engine] = (closed(), online())
                continue
            runs[engine] = (closed(), online())
        assert runs["scalar"][0].replans > 0
        for engine, tol in (("vec", 0.0), ("torch", 1e-9)):
            for got, want in zip(runs[engine], runs["scalar"]):
                assert abs(got.mean_fid - want.mean_fid) <= tol
        pex.ExecutionLoop(scn, rep.plan, rep.allocation,
                          pex.SimulatedSession(rep.plan, pd.DelayModel()),
                          mode="open", engine="scalar")


class TestExecuteReport:
    @pytest.mark.parametrize("mode", ["open", "closed"])
    def test_from_report_equal(self, mode):
        ref, got = _pair(dict(K=4, seed=5), execute=False)
        kw = dict(min_batches=2, drift_tol=0.2, executor="simulated")
        r = jax_execute_report(ref, mode=mode, executor_kwargs={
            "true_delay": jd.DelayModel(*TRUE)}, **kw)
        g = execute_report(got, mode=mode, executor_kwargs={
            "true_delay": pd.DelayModel(*TRUE)}, **kw)
        assert isinstance(g, ExecutionResult) and g.mode == mode
        assert len(g.records) > 0
        _same_execution(r, g)

    def test_executor_table(self):
        assert set(EXECUTORS.names()) == {"diffusion", "llm_decode",
                                          "simulated"}
        scn = ps.make_scenario(K=3, seed=0)
        rep = Provisioner(scn, allocator="inv_se").run(execute=False)
        with pytest.raises(KeyError, match="unknown executor"):
            execute_plan(scn, rep.plan, rep.allocation, executor="gpu")
        with pytest.raises(ValueError, match="no executor"):
            execute_plan(scn, rep.plan, rep.allocation)
        with pytest.raises(ValueError, match="diffusion-only"):
            execute_plan(scn, rep.plan, rep.allocation,
                         executor="simulated", exec_engine="bucketed",
                         executor_kwargs={
                             "true_delay": pd.DelayModel(*TRUE)})

    def test_report_refit_closes_the_loop(self):
        """Timed simulated execution -> report.refit_delay recovers the
        true model, as the reference's does."""
        ref, got = _pair(dict(K=5, seed=8), execute="open")
        m, r = got.refit_delay(), ref.refit_delay()
        assert (m.a, m.b) == (r.a, r.b)
        assert m.a == pytest.approx(TRUE[0], rel=1e-6)
        assert m.b == pytest.approx(TRUE[1], rel=1e-6)


def _online(pkg, scn_kw, allocator, admission):
    if pkg == "ref":
        scn = js.make_scenario(**scn_kw)
        sched, dm, q = jax_stacking, jd.DelayModel, JaxFID()
        alloc = (lambda s, *_: jax_inv_se(s)) if allocator == "inv_se" else \
            (lambda s, sch, d, qq: jax_pso(s, sch, d, qq, num_particles=4,
                                           iters=2, seed=1).alloc)
        return jon.simulate_online(scn, sched, alloc, dm(*TRUE), q,
                                   admission)
    scn = ps.make_scenario(**scn_kw)
    alloc = ALLOCATORS.get(allocator)
    if allocator == "pso":
        alloc = with_kwargs(alloc, dict(num_particles=4, iters=2, seed=1))
    return pon.simulate_online(scn, stacking, alloc, pd.DelayModel(*TRUE),
                               PowerLawFID(), admission)


def _feasible(svc, projected, states):
    return projected.steps > 0 and projected.met_deadline


class TestOnline:
    @pytest.mark.parametrize("admission", [None, _feasible])
    @pytest.mark.parametrize("allocator", ["inv_se", "pso"])
    @pytest.mark.parametrize("scn_kw", [
        dict(K=6, arrival_rate=0.5, seed=6),
        dict(K=8, arrival_rate=2.0, tau_min=3.0, tau_max=8.0, seed=11),
        dict(K=5, seed=3),                           # all at t=0
    ])
    def test_simulate_online_equal(self, scn_kw, allocator, admission):
        ref = _online("ref", scn_kw, allocator, admission)
        got = _online("port", scn_kw, allocator, admission)
        assert [dataclasses.astuple(o) for o in got.outcomes] == \
            [dataclasses.astuple(o) for o in ref.outcomes]
        assert [(d.id, d.arrival, d.admitted,
                 dataclasses.astuple(d.projected)) for d in got.decisions] \
            == [(d.id, d.arrival, d.admitted,
                 dataclasses.astuple(d.projected)) for d in ref.decisions]
        assert (got.mean_fid, got.outage_rate, got.reject_rate) == \
            (ref.mean_fid, ref.outage_rate, ref.reject_rate)
        assert got.executed_batches == ref.executed_batches
        assert got.summary() == ref.summary()

    def test_arrivals_drawn_equal(self):
        ref = js.make_scenario(K=9, arrival_rate=1.5, seed=4)
        got = ps.make_scenario(K=9, arrival_rate=1.5, seed=4)
        assert [dataclasses.astuple(s) for s in got.services] == \
            [(s.id, s.deadline, s.spectral_eff, s.arrival, s.content_bits)
             for s in ref.services]
        with pytest.raises(ValueError, match="arrival_rate"):
            ps.make_scenario(K=2, arrival_rate=0.0)

    def test_replay_plan_and_result_equal(self):
        scn_kw = dict(K=6, arrival_rate=0.5, seed=6)
        ref = _online("ref", scn_kw, "inv_se", None)
        got = _online("port", scn_kw, "inv_se", None)
        steps = {o.id: o.steps for o in got.outcomes}
        rp = jax_replay_plan(ref.executed_batches, steps,
                             jd.DelayModel(*TRUE))
        gp = replay_plan(got.executed_batches, steps, pd.DelayModel(*TRUE))
        assert (gp.batches, gp.start_times, gp.steps_completed) == \
            (rp.batches, rp.start_times, rp.steps_completed)
        with pytest.raises(AssertionError, match="disagrees"):
            replay_plan(got.executed_batches, {0: 99},
                        pd.DelayModel(*TRUE))
        r = jax_replay_result(None, ref, jd.DelayModel(*TRUE),
                              executor="simulated", executor_kwargs={
                                  "true_delay": jd.DelayModel(*TRUE)})
        g = replay_result(None, got, pd.DelayModel(*TRUE),
                          executor="simulated", executor_kwargs={
                              "true_delay": pd.DelayModel(*TRUE)})
        assert (g.content, g.timings) == (r.content, r.timings)
        assert g.content == steps
