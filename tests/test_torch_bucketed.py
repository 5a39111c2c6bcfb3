"""The port's bucketed pool engine (``repro_torch.diffusion.bucketed``)
on the CPU, where its programs run eagerly (on the card each is a CUDA
graph: tests/test_torch_cuda.py).

Against the port's own dict engine the images are held within the
reference's ``MATCH_TOL`` (atol = rtol = 1e-5); against ``repro``'s
bucketed engine, from the JAX session's latents and the same params,
within 1e-4 (the U-Net forward's tolerance, tests/test_torch_unet.py).
The scheduling counters (dispatches, buckets, fused steps) and the
telemetry keys are held equal to the reference's on the same plans.
Mirrors tests/test_exec_bucketed.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.api.execution import execute_plan as jax_execute_plan  # noqa: E402
from repro.api.workloads import DiffusionWorkload as JaxWorkload  # noqa: E402
from repro.configs.ddim_cifar10 import UNetConfig as JaxUNetConfig  # noqa: E402
from repro.core.execution import shape_bucket as jax_shape_bucket  # noqa: E402
from repro.core.service import make_scenario as jax_scenario  # noqa: E402
from repro.diffusion import unet as jax_unet  # noqa: E402
from repro.diffusion.bucketed import MATCH_TOL as JAX_MATCH_TOL  # noqa: E402
from repro.diffusion.bucketed import _SCAN_CHUNKS as JAX_CHUNKS  # noqa: E402
from repro.diffusion.executor import BatchDenoisingExecutor as JaxExecutor  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro_torch.api import DiffusionWorkload, execute_plan  # noqa: E402
from repro_torch.configs.ddim_cifar10 import SMOKE, UNetConfig  # noqa: E402
from repro_torch.core.bandwidth import inv_se_allocate  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.execution import (EXEC_ENGINES,  # noqa: E402
                                        exec_engine_default, shape_bucket)
from repro_torch.core.plan import BatchPlan  # noqa: E402
from repro_torch.core.service import make_scenario  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.diffusion.bucketed import (MATCH_TOL,  # noqa: E402
                                            _SCAN_CHUNKS,
                                            BucketedDenoiseSession,
                                            pool_scan, pool_step)
from repro_torch.diffusion.executor import BatchDenoisingExecutor  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from test_torch_executor import KEY, _latents, _plans, make_executors  # noqa: E402

XTOL = 1e-4                 # across frameworks: the U-Net's tolerance

# the reference test's tiny U-Net: its JAX programs compile quickly
MICRO = dict(name="ddim-micro-test", image_size=8, base_channels=8,
             channel_mults=(1,), num_res_blocks=1, attn_resolutions=(),
             num_groups=4)


@pytest.fixture(scope="module")
def micro():
    """(reference executor, port executor) on MICRO, same params."""
    cfg = JaxUNetConfig(**MICRO)
    params = jax_init_params(jax_unet.schema(cfg), jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, params)
    port = BatchDenoisingExecutor(
        UNetConfig(**MICRO),
        params_from_numpy(unet.schema(UNetConfig(**MICRO)), host, "cpu"),
        device="cpu")
    return JaxExecutor(cfg, params), port


@pytest.fixture(scope="module")
def smoke():
    """(reference executor, port executor) on SMOKE, conv_out redrawn
    (test_torch_executor.py's)."""
    return make_executors()


def make_plan(counts, batches):
    """A BatchPlan from explicit step counts and batch sequence."""
    idx = {k: 0 for k in counts}
    bb = []
    for ks in batches:
        bb.append([(k, idx[k]) for k in ks])
        for k in ks:
            idx[k] += 1
    assert idx == dict(counts), "batches disagree with step counts"
    return BatchPlan(batches=bb, start_times=[0.0] * len(bb),
                     steps_completed=dict(counts), delay=DelayModel())


def stacking_batches(counts):
    """All-active-together rounds (composition shrinks as services
    retire), as the reference test builds them."""
    rem = dict(counts)
    out = []
    while any(v > 0 for v in rem.values()):
        ks = sorted(k for k, v in rem.items() if v > 0)
        out.append(ks)
        for k in ks:
            rem[k] -= 1
    return out


def gen(seed):
    return torch.Generator().manual_seed(seed)


def assert_rows_match(got, want, tol=MATCH_TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol,
                                   err_msg=f"service {k}")


FIXED = [
    {0: 3, 1: 3, 2: 3},                    # one stable phase
    {0: 5, 1: 3, 2: 1, 3: 0},              # staggered + zero-step
    {0: 1, 1: 2, 2: 3, 3: 4, 4: 7},        # many distinct sizes
    {k: 40 for k in range(3)},             # a 32-step chunk + 8
]


class TestEnginesMatch:
    def test_tolerance_and_chunks_are_the_reference_s(self):
        assert MATCH_TOL == JAX_MATCH_TOL
        assert _SCAN_CHUNKS == JAX_CHUNKS and _SCAN_CHUNKS[-1] == 2

    @pytest.mark.parametrize("counts", FIXED)
    def test_fixed_plans(self, micro, counts):
        ex = micro[1]
        plan = make_plan(counts, stacking_batches(counts))
        want, _ = ex.run(plan, gen(42), exec_engine="dict")
        got, _ = ex.run(plan, gen(42), exec_engine="bucketed")
        assert_rows_match(got, want)
        moved = [k for k, T in counts.items() if T >= 2]  # 1 step: t = 0
        plain = ex.open_session(plan, gen(42)).finish()
        assert all(np.abs(got[k] - plain[k]).max() > 1e-3 for k in moved)

    def test_timed_matches_untimed(self, micro):
        ex = micro[1]
        counts = {0: 4, 1: 4, 2: 2}
        plan = make_plan(counts, stacking_batches(counts))
        plain, no_t = ex.run(plan, gen(7), exec_engine="bucketed")
        timed, ts = ex.run(plan, gen(7), timed=True, exec_engine="bucketed")
        assert no_t == [] and len(ts) == plan.num_batches
        assert [x for x, _ in ts] == plan.batch_sizes()
        assert_rows_match(timed, plain)

    def test_zero_step_latent_untouched(self, micro):
        ex = micro[1]
        plan = make_plan({0: 0, 1: 2}, [[1], [1]])
        latents = {k: np.random.default_rng(k).standard_normal(
            (8, 8, 3)).astype(np.float32) for k in (0, 1)}
        imgs, _ = ex.run(plan, latents=latents, exec_engine="bucketed")
        np.testing.assert_array_equal(imgs[0], latents[0])
        assert np.abs(imgs[1] - latents[1]).max() > 1e-3

    def test_pool_functions(self, micro):
        """pool_step leaves rows outside idx and pass-through lanes
        (t_now = -1) exactly as they were; pool_scan is repeated
        pool_step."""
        ex = micro[1]
        pool = torch.randn((5, 8, 8, 3), generator=gen(1))
        a, b = pool.clone(), pool.clone()
        idx = torch.tensor([3, 1, 4, 4])
        ts = torch.tensor([[[500, 300, -1, -1], [499, 299, -1, -1]],
                           [[499, 299, -1, -1], [-1, 298, -1, -1]]])
        pool_scan(ex.step_fn, a, idx, ts)
        for t in ts:
            pool_step(ex.step_fn, b, idx, t[0], t[1])
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        for r in (0, 2, 4):
            torch.testing.assert_close(a[r], pool[r], rtol=0, atol=0)
        assert (a[3] - pool[3]).abs().max() > 1e-3


    @pytest.mark.parametrize("K", [1, 2, 3, 7, 8, 9])
    def test_pool_rows_are_a_power_of_two_with_scratch_last(self, micro, K):
        """A session over K services holds shape_bucket(K + 1) pool rows,
        the scratch row last; the rows between are zero and never
        gathered, so the images are those of the dict engine."""
        from repro_torch.core.execution import shape_bucket
        ex = micro[1]
        counts = {k: k % 3 + 1 for k in range(K)}
        plan = make_plan(counts, stacking_batches(counts))
        sess = ex.open_session(plan, gen(3), exec_engine="bucketed")
        rows = sess._pool.rows
        assert rows == shape_bucket(K + 1) and sess._scratch == rows - 1
        sess.run_plan([[k for k, _ in b] for b in plan.batches])
        assert not sess._pool.tensor[K:].any()
        want, _ = ex.run(plan, gen(3), exec_engine="dict")
        assert_rows_match(sess.finish(), want)


class TestScheduling:
    def test_retarget_mid_scan(self, micro):
        """Retargeting between run_plan calls lands on the same images
        as the dict session driven identically."""
        ex = micro[1]
        counts = {0: 6, 1: 6, 2: 6}
        sessions = [ex.open_session(make_plan(counts,
                                              stacking_batches(counts)),
                                    gen(3), exec_engine=e)
                    for e in ("dict", "bucketed")]
        for sess in sessions:
            sess.run_plan([[0, 1, 2]] * 3)        # fused on bucketed
            sess.retarget({0: 4, 1: 8})           # shrink / stretch
            sess.run_batch([0, 1, 2])
            sess.run_plan([[1, 2]] * 2)           # 0 retired at 4
            sess.run_plan([[1]] * 2)
            assert sess.steps_done == {0: 4, 1: 8, 2: 6}
        assert sessions[1].telemetry()["scan_fused_steps"] == 6   # 2+2+2
        assert_rows_match(sessions[1].finish(), sessions[0].finish())

    def test_scan_breaks_on_composition_change(self, micro):
        ex = micro[1]
        counts = {0: 5, 1: 4, 2: 2}
        batches = [[0, 1], [0, 1], [0, 1], [0, 2], [0, 2], [1]]
        plan = make_plan(counts, batches)
        sess = ex.open_session(plan, gen(9), exec_engine="bucketed")
        sess.run_plan([list(b) for b in batches])
        tele = sess.telemetry()
        # [0,1]x3 -> scan(2)+step; [0,2]x2 -> scan(2); [1] -> step
        assert tele["scan_fused_steps"] == 4
        assert tele["scan_dispatches"] == {"b2_c2": 2}
        assert tele["by_bucket"] == {"2": 2}
        want, _ = ex.run(plan, gen(9), exec_engine="dict")
        assert_rows_match(sess.finish(), want)

    def test_retarget_errors_preserved(self, micro):
        ex = micro[1]
        counts = {0: 3, 1: 3}
        plan = make_plan(counts, stacking_batches(counts))
        sess = ex.open_session(plan, gen(1), exec_engine="bucketed")
        sess.run_batch([0, 1])
        with pytest.raises(ValueError, match="already executed"):
            sess.retarget({0: 0})
        sess.retarget({0: 1})
        with pytest.raises(ValueError, match="no remaining"):
            sess.run_batch([0])
        with pytest.raises(ValueError, match="no remaining"):
            sess.run_plan([[0, 1], [0, 1]])     # the scan checks too
        assert sess.latents is None             # the pool is the truth

    @pytest.mark.parametrize("counts, batches", [
        ({0: 5, 1: 4, 2: 2},
         [[0, 1], [0, 1], [0, 1], [0, 2], [0, 2], [1]]),
        ({k: k + 1 for k in range(8)}, None),   # sizes 8, 7, ..., 1
        ({0: 37, 1: 37, 2: 30, 3: 0}, None),    # chunks 16+8+4+2, then 4+2+1
    ])
    def test_counters_equal_reference(self, micro, counts, batches):
        jex, ex = micro
        batches = batches or stacking_batches(counts)
        plan = make_plan(counts, batches)
        jsess = jex.open_session(plan, jax.random.PRNGKey(2),
                                 exec_engine="bucketed")
        sess = ex.open_session(plan, gen(2), exec_engine="bucketed")
        for s in (jsess, sess):
            s.run_plan([list(b) for b in batches])
        jt, pt = jsess.telemetry(), sess.telemetry()
        assert set(pt) == set(jt)
        for key in ("exec_engine", "dispatches", "by_bucket",
                    "scan_dispatches", "scan_fused_steps"):
            assert pt[key] == jt[key], key
        assert pt["compiles"] == 0 and pt["compile_s_by_bucket"] == {}
        assert sess.steps_done == jsess.steps_done
        assert ex.compile_log == []             # nothing captured on the CPU


class TestEngineKnob:
    def test_registry_and_default(self, monkeypatch):
        assert EXEC_ENGINES == ("dict", "bucketed")
        monkeypatch.delenv("REPRO_EXEC_ENGINE", raising=False)
        assert exec_engine_default() == "dict"
        monkeypatch.setenv("REPRO_EXEC_ENGINE", "bucketed")
        assert exec_engine_default() == "bucketed"

    def test_env_default_opens_bucketed(self, micro, monkeypatch):
        monkeypatch.setenv("REPRO_EXEC_ENGINE", "bucketed")
        plan = make_plan({0: 1}, [[0]])
        assert isinstance(micro[1].open_session(plan),
                          BucketedDenoiseSession)

    def test_unknown_engine_rejected(self, micro):
        ex = micro[1]
        plan = make_plan({0: 1}, [[0]])
        with pytest.raises(ValueError, match="unknown exec_engine"):
            ex.open_session(plan, exec_engine="gpu")
        with pytest.raises(ValueError, match="unknown exec_engine"):
            BatchDenoisingExecutor(ex.cfg, ex.params, device="cpu",
                                   exec_engine="gpu")

    def test_workload_engine_knob(self, micro):
        ex = micro[1]
        wl = DiffusionWorkload(executor=ex)
        plan = make_plan({0: 2, 1: 1}, [[0, 1], [0]])
        sess = wl.open_session(plan, gen(0), exec_engine="bucketed")
        assert isinstance(sess, BucketedDenoiseSession)
        a = wl.execute(plan, gen(0), exec_engine="bucketed").content
        b = wl.execute(plan, gen(0), exec_engine="dict").content
        assert_rows_match(a, b)

    @pytest.mark.parametrize("execute", ["open", "closed"])
    def test_provisioner_loop_takes_latents(self, micro, execute):
        """Provisioner.run(execute=..., latents=...) starts the loop's
        session from the given noise: open loop, the images are those of
        the same plan run directly from it; closed (replans on the CPU's
        timings), service 0, whose deadline fits no step, comes back as
        its latent exactly."""
        from repro_torch.api import Provisioner
        from repro_torch.core.service import Scenario, ServiceRequest
        ex = micro[1]
        scn = Scenario(services=[
            ServiceRequest(id=k, deadline=d, spectral_eff=7.0)
            for k, d in enumerate((0.001, 0.4, 0.5))], content_bits=512.0)
        lat = {k: np.random.default_rng(k).standard_normal(
            (8, 8, 3)).astype(np.float32) for k in range(3)}
        rep = Provisioner(scn, workload=DiffusionWorkload(executor=ex),
                          allocator="inv_se", delay=DelayModel(0.01, 0.05),
                          execute_kwargs={"exec_engine": "bucketed"}).run(
            execute=execute, latents=lat)
        res = rep.execution
        assert res.exec_engine == "bucketed" and len(res.records) > 0
        assert rep.to_dict()["telemetry"]["exec_engine"] == "bucketed"
        np.testing.assert_array_equal(rep.content[0], lat[0])
        if execute == "open":
            want, _ = ex.run(rep.plan, latents=lat, exec_engine="dict")
            assert_rows_match(rep.content, want)
        for k in (1, 2):
            assert np.abs(rep.content[k] - lat[k]).max() > 1e-3

    def test_provisioner_refit_adopts_measured_delay(self, micro):
        """run(refit=True) times the one-shot execution and plans the
        next run with the fit of its timings."""
        from repro_torch.api import Provisioner
        ex = micro[1]
        p = Provisioner(make_scenario(K=3, tau_min=0.3, tau_max=0.6,
                                      seed=4),
                        workload=DiffusionWorkload(executor=ex,
                                                   exec_engine="bucketed"),
                        allocator="inv_se", delay=DelayModel(0.01, 0.05))
        rep = p.run(refit=True)
        assert len(rep.timings) == rep.plan.num_batches
        assert len(set(rep.plan.batch_sizes())) >= 2
        assert p.delay == rep.refit_delay() != DelayModel(0.01, 0.05)

    def test_shape_bucket_grid(self):
        ns = (1, 2, 3, 4, 5, 8, 9, 16, 17, 33)
        assert [shape_bucket(n) for n in ns] == \
            [jax_shape_bucket(n) for n in ns] == \
            [2, 2, 4, 4, 8, 8, 16, 16, 32, 64]

    def test_delay_curve_shares_bucket_programs(self, micro):
        """Sizes of one bucket run the same padded program: 1..8 on
        buckets 2, 4, 8; on the CPU nothing is captured."""
        ex = micro[1]
        d0, f0 = ex.dispatches, ex.forwards
        curve = ex.measure_delay_curve(gen(6), batch_sizes=range(1, 9),
                                       reps=2, exec_engine="bucketed")
        assert [x for x, _ in curve] == list(range(1, 9))
        assert all(s > 0 for _, s in curve)
        assert ex.dispatches - d0 == 8 * 3       # warm + 2 readings a size
        assert ex.forwards - f0 == 8 * 3
        assert ex.last_compile_log == []


class TestAgainstReferenceBucketed:
    def test_images_match_reference_bucketed(self, smoke):
        """repro's bucketed engine and the port's, SMOKE, same params,
        the JAX session's latents, a STACKING plan of mixed sizes."""
        jax_ex, port = smoke
        jplan, plan = _plans()
        want, _ = jax_ex.run(jplan, KEY, exec_engine="bucketed")
        latents = _latents(jax_ex, jplan)
        got, _ = port.run(plan, latents=latents, exec_engine="bucketed")
        dict_got, _ = port.run(plan, latents=latents, exec_engine="dict")
        assert_rows_match(got, want, tol=dict(atol=XTOL, rtol=XTOL))
        assert_rows_match(got, dict_got)
        for k in want:
            assert np.abs(got[k] - latents[k]).max() > 1e-2   # denoised

    @pytest.mark.parametrize("engine", ["dict", "bucketed"])
    def test_open_loop_execute_plan_matches_reference(self, smoke, engine):
        """execute_plan(mode="open") on the "diffusion" executor: the
        same batches and the same images within 1e-4."""
        jax_ex, port = smoke
        kw = dict(K=3, tau_min=1.5, tau_max=3.0, seed=4)
        jscn, scn = jax_scenario(**kw), make_scenario(**kw)
        jplan, plan = _plans()
        ref = jax_execute_plan(
            jscn, jplan, np.asarray(inv_se_allocate(scn)),
            JaxWorkload(executor=jax_ex), mode="open", key=KEY,
            exec_engine=engine)
        got = execute_plan(
            scn, plan, inv_se_allocate(scn), DiffusionWorkload(
                executor=port), mode="open", exec_engine=engine,
            executor_kwargs={"latents": _latents(jax_ex, jplan)})
        assert got.exec_engine == ref.exec_engine == engine
        assert [r.size for r in got.records] == \
            [r.size for r in ref.records] == plan.batch_sizes()
        # the times are each run's own measurements
        assert [e[1:] for e in got.executed_log] == \
            [e[1:] for e in ref.executed_log]
        assert got.replans == ref.replans == 0
        assert set(got.session_telemetry) == set(ref.session_telemetry)
        assert got.session_telemetry["dispatches"] == \
            ref.session_telemetry["dispatches"] == plan.num_batches
        assert_rows_match(got.content, ref.content,
                          tol=dict(atol=XTOL, rtol=XTOL))
