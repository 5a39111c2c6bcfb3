"""The port's DDIM schedule helpers and step against ``repro.diffusion.ddim``.

The NumPy helpers are copies and must agree exactly.  ``ddim_step`` is
held at 1e-5 (the reference's ``MATCH_TOL``, bucketed.py) with the same
eps function on both sides, on a batch that mixes finished rows
(t_now = -1) and last steps (t_next = -1).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.diffusion import ddim as jax_ddim  # noqa: E402
from repro_torch.diffusion import ddim  # noqa: E402

MATCH_TOL = 1e-5


@pytest.mark.parametrize("T", [1, 3, 10, 50, 999, 1000, 1500])
def test_schedule_helpers_equal(T):
    np.testing.assert_array_equal(ddim.ddim_timesteps(T),
                                  jax_ddim.ddim_timesteps(T))
    np.testing.assert_array_equal(ddim.schedule_table(T),
                                  jax_ddim.schedule_table(T))
    for t_start in (0, 5, 499, 999):
        np.testing.assert_array_equal(ddim.retarget_timesteps(t_start, T),
                                      jax_ddim.retarget_timesteps(t_start, T))


def test_betas_and_alphas_equal():
    np.testing.assert_array_equal(ddim.make_betas(), jax_ddim.make_betas())
    np.testing.assert_array_equal(ddim.alphas_cumprod(),
                                  jax_ddim.alphas_cumprod())
    np.testing.assert_array_equal(ddim.retarget_timesteps(7, 0),
                                  jax_ddim.retarget_timesteps(7, 0))


def test_ddim_step_matches_mixed_batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 4, 4, 3)).astype(np.float32)
    w = rng.standard_normal(3).astype(np.float32)
    t_now = np.array([999, 500, 20, -1, 0], np.int32)
    t_next = np.array([980, 400, -1, -1, -1], np.int32)

    def jax_eps(x, t):
        return jnp.tanh(x * jnp.asarray(w)) + t[:, None, None, None] / 1e3

    def torch_eps(x, t):
        return (torch.tanh(x * torch.from_numpy(w))
                + t[:, None, None, None] / 1e3)

    want = np.asarray(jax_ddim.ddim_step(jax_eps, jnp.asarray(x),
                                         jnp.asarray(t_now),
                                         jnp.asarray(t_next)))
    got = ddim.ddim_step(torch_eps, torch.from_numpy(x),
                         torch.from_numpy(t_now).long(),
                         torch.from_numpy(t_next).long()).numpy()
    np.testing.assert_allclose(got, want, atol=MATCH_TOL, rtol=MATCH_TOL)
    np.testing.assert_array_equal(got[3], x[3])      # t_now < 0 passes


def test_sample_runs_the_chain():
    """``sample`` takes T steps from generator noise: with eps = 0 the
    chain rescales x by sqrt(alpha_bar) ratios down to x0."""
    gen = torch.Generator().manual_seed(0)
    out = ddim.sample(lambda x, t: torch.zeros_like(x), gen, (2, 4, 4, 3),
                      T=4, device="cpu")
    x = torch.randn((2, 4, 4, 3), generator=torch.Generator().manual_seed(0))
    acp = ddim.alphas_cumprod()
    t0 = ddim.ddim_timesteps(4)[0]
    np.testing.assert_allclose(out.numpy(), x.numpy() / np.sqrt(acp[t0]),
                               rtol=1e-5)
