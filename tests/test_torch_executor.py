"""The port's ``"dict"`` batch-denoising executor against
``repro.diffusion.executor`` on SMOKE, with the same params (conv_out
redrawn, see test_torch_unet.py) and the reference session's latents.

Image tolerance 1e-4: the U-Net forward's own tolerance
(test_torch_unet.py), carried through a few DDIM steps.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.bandwidth import inv_se_allocate as jax_inv_se  # noqa: E402
from repro.core.bandwidth import tau_prime_of as jax_tau_prime  # noqa: E402
from repro.core.delay_model import DelayModel as JaxDelay  # noqa: E402
from repro.core.plan import BatchPlan as JaxPlan  # noqa: E402
from repro.core.quality_model import PowerLawFID as JaxFID  # noqa: E402
from repro.core.service import make_scenario as jax_scenario  # noqa: E402
from repro.core.stacking import stacking as jax_stacking  # noqa: E402
from repro.diffusion.executor import BatchDenoisingExecutor as JaxExecutor  # noqa: E402
from repro_torch.configs.ddim_cifar10 import SMOKE  # noqa: E402
from repro_torch.core.bandwidth import inv_se_allocate, tau_prime_of  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.plan import BatchPlan  # noqa: E402
from repro_torch.core.quality_model import PowerLawFID  # noqa: E402
from repro_torch.core.service import make_scenario  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.diffusion.executor import BatchDenoisingExecutor  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from test_torch_unet import redrawn_params  # noqa: E402

TOL = 1e-4
KEY = jax.random.PRNGKey(3)


@pytest.fixture(scope="module")
def executors():
    return make_executors()


def make_executors():
    params = redrawn_params(SMOKE)
    port = BatchDenoisingExecutor(
        SMOKE, params_from_numpy(unet.schema(SMOKE), params, "cpu"),
        device="cpu")
    return JaxExecutor(SMOKE, params), port


def _plans(seed=4):
    kw = dict(K=3, tau_min=1.5, tau_max=3.0, seed=seed)
    jscn, scn = jax_scenario(**kw), make_scenario(**kw)
    jplan = jax_stacking(jscn.services,
                         jax_tau_prime(jscn, jax_inv_se(jscn)),
                         JaxDelay(), JaxFID())
    plan = stacking(scn.services, tau_prime_of(scn, inv_se_allocate(scn)),
                    DelayModel(), PowerLawFID())
    assert plan.batches == jplan.batches
    return jplan, plan


def _two_step_plans():
    batches = [[(0, 0)], [(0, 1)]]
    steps = {0: 2, 1: 0}
    return (JaxPlan(batches, [0.0, 1.0], steps, JaxDelay()),
            BatchPlan(batches, [0.0, 1.0], dict(steps), DelayModel()))


def _latents(jax_ex, jplan):
    sess = jax_ex.open_session(jplan, KEY)
    return {k: np.asarray(v) for k, v in sess.latents.items()}


def test_plan_images_match_reference(executors):
    want, got, latents, plan, dispatched, timings = plan_images(*executors)
    assert dispatched == plan.num_batches            # one forward a batch
    assert [x for x, _ in timings] == plan.batch_sizes()
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.abs(got[k] - latents[k]).max() > 1e-2   # denoised
        np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=TOL)


def plan_images(jax_ex, port):
    """Both executors on one STACKING plan from the same latents."""
    jplan, plan = _plans()
    assert len(set(plan.batch_sizes())) >= 2          # mixed batch sizes
    want, _ = jax_ex.run(jplan, KEY)
    latents = _latents(jax_ex, jplan)
    d0 = port.dispatches
    got, timings = port.run(plan, latents=latents, timed=True)
    return want, got, latents, plan, port.dispatches - d0, timings


def test_zero_step_service_returns_untouched_latent(executors):
    jax_ex, port = executors
    jplan, plan = _two_step_plans()
    latents = _latents(jax_ex, jplan)
    got, _ = port.run(plan, latents=latents)
    np.testing.assert_array_equal(got[1], latents[1])
    want, _ = jax_ex.run(jplan, KEY)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)


def test_session_without_latents_draws_from_generator(executors):
    _, port = executors
    _, plan = _two_step_plans()
    a = port.open_session(plan, torch.Generator().manual_seed(5)).finish()
    b = port.open_session(plan, torch.Generator().manual_seed(5)).finish()
    c = port.open_session(plan, torch.Generator().manual_seed(6)).finish()
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[1], c[1])


@pytest.mark.parametrize("case", ["below_done", "resurrect"])
def test_retarget_raises_where_reference_raises(executors, case):
    jax_ex, port = executors
    jplan, plan = _two_step_plans()
    sessions = [jax_ex.open_session(jplan, KEY),
                port.open_session(plan, latents=_latents(jax_ex, jplan))]
    for sess in sessions:
        sess.run_batch([0])
        if case == "below_done":
            totals = {0: 0}
        else:
            sess.run_batch([0])                       # fully denoised
            totals = {0: 3}
        with pytest.raises(ValueError):
            sess.retarget(totals)
        sess.retarget({0: sess.steps_done[0]})        # retire in place: ok
        with pytest.raises(ValueError):
            sess.run_batch([0])                       # nothing remains


def test_retarget_rebuilds_the_chain(executors):
    jax_ex, port = executors
    jplan, plan = _two_step_plans()
    sessions = [jax_ex.open_session(jplan, KEY),
                port.open_session(plan, latents=_latents(jax_ex, jplan))]
    for sess in sessions:
        sess.run_batch([0])
        sess.retarget({0: 4, 1: 2})
    assert sessions[0]._remaining == sessions[1]._remaining


def test_telemetry_has_the_reference_keys(executors):
    jax_ex, port = executors
    jplan, plan = _two_step_plans()
    jsess = jax_ex.open_session(jplan, KEY)
    psess = port.open_session(plan, latents=_latents(jax_ex, jplan))
    for sess in (jsess, psess):
        sess.run_batch([0])
    jt, pt = jsess.telemetry(), psess.telemetry()
    assert set(pt) == set(jt)
    assert pt["dispatches"] == jt["dispatches"] == 1
    assert pt["by_size"] == jt["by_size"]
    assert pt["exec_engine"] == "dict" and pt["compiles"] == 0


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_executor.py
    want, got, _, plan, *_ = plan_images(*make_executors())
    err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    print(f"SMOKE plan ({plan.num_batches} batches, steps "
          f"{plan.steps_completed}), port vs reference dict executor on the "
          f"CPU: max abs err {err:.3g}, max |image| {scale:.3g}")
