"""The port's Mamba2 block (``repro_torch.models.ssm``) against
``repro.models.ssm`` on the same params and inputs: ``mamba2_forward``
(y and both states, fresh and continued from a state) and
``mamba2_step`` (y and both states), at zamba2's smoke width (d 256,
d_inner 512, 8 heads of P = 64, N = 16).  The params come from the
reference's ``init_params``, with A_log, dt_bias, D and conv_b redrawn
(they start at 0 or 1) so the decays and skips are not trivial.

Tolerance 1e-4 (atol and rtol): float32 sums in another order through
the 256- and 512-term projections and the chunk scan.  The reference's
jnp ``ssd_chunked`` is the Pallas kernel's arithmetic
(tests/test_torch_ssd_scan.py holds the two together).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

TOL = 1e-4
B, S = 2, 32


@pytest.fixture(scope="module")
def block():
    cfg = smoke_variant(get_config("zamba2-2.7b"))
    jcfg = jax_smoke(jax_get_config("zamba2-2.7b"))
    rng = np.random.default_rng(3)
    p = jax.tree_util.tree_map(
        np.asarray, jax_init(jax_ssm.mamba2_schema(jcfg),
                             jax.random.PRNGKey(1)))
    H = p["A_log"].shape[0]
    p.update(A_log=rng.standard_normal(H).astype(np.float32) * 0.5,
             dt_bias=rng.standard_normal(H).astype(np.float32) * 0.5,
             D=(1 + rng.standard_normal(H) * 0.1).astype(np.float32),
             conv_b=(rng.standard_normal(p["conv_b"].shape) * 0.1
                     ).astype(np.float32))
    u = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return (cfg, jcfg, params_from_numpy(ssm.mamba2_schema(cfg), p, "cpu"),
            {k: jnp.asarray(v) for k, v in p.items()}, u)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _state_close(got, want):
    for key in ("conv", "ssm"):
        assert got[key].dtype == torch.float32
        assert got[key].shape == want[key].shape
        _close(got[key], want[key])


def test_full_width_dims():
    cfg = get_config("zamba2-2.7b")
    assert ssm.ssm_dims(cfg) == (5120, 80, 64)
    sch = ssm.mamba2_schema(cfg)
    assert sch["in_bcdt"].shape == (2560, 2 * 64 + 80)
    assert sch["conv_w"].shape == (4, 5120 + 128)


@pytest.mark.parametrize("chunk", [16, 128])
def test_mamba2_forward_matches_reference(block, chunk):
    cfg, jcfg, p, jp, u = block
    y, st = ssm.mamba2_forward(cfg, p, torch.tensor(u), chunk=chunk)
    jy, jst = jax_ssm.mamba2_forward(jcfg, jp, jnp.asarray(u), chunk=chunk)
    assert y.shape == (B, S, cfg.d_model)
    _close(y, jy)
    _state_close(st, jst)


def test_mamba2_forward_continues_from_a_state(block):
    """The second half of the sequence from the first half's states
    (the conv state pads, h0 is non-zero), against the reference."""
    cfg, jcfg, p, jp, u = block
    half = S // 2
    _, st = ssm.mamba2_forward(cfg, p, torch.tensor(u[:, :half]))
    _, jst = jax_ssm.mamba2_forward(jcfg, jp, jnp.asarray(u[:, :half]))
    y, st2 = ssm.mamba2_forward(cfg, p, torch.tensor(u[:, half:]), st)
    jy, jst2 = jax_ssm.mamba2_forward(jcfg, jp, jnp.asarray(u[:, half:]),
                                      jst)
    _close(y, jy)
    _state_close(st2, jst2)


@pytest.mark.parametrize("conv_dtype", ["float32", "bfloat16"])
def test_mamba2_step_matches_reference(block, conv_dtype):
    """One decode step after a prefill of S - 1 tokens; a bfloat16 conv
    state (the cache's type) comes back float32, as in the reference."""
    cfg, jcfg, p, jp, u = block
    _, st = ssm.mamba2_forward(cfg, p, torch.tensor(u[:, :-1]))
    _, jst = jax_ssm.mamba2_forward(jcfg, jp, jnp.asarray(u[:, :-1]))
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[conv_dtype]
    st = dict(st, conv=st["conv"].to(tdt))
    jst = dict(jst, conv=jst["conv"].astype(jdt))
    y, st2 = ssm.mamba2_step(cfg, p, torch.tensor(u[:, -1:]), st)
    jy, jst2 = jax_ssm.mamba2_step(jcfg, jp, jnp.asarray(u[:, -1:]), jst)
    assert y.shape == (B, 1, cfg.d_model)
    _close(y, jy)
    _state_close(st2, jst2)
    # the step is the recurrence the chunked scan runs
    yf, _ = ssm.mamba2_forward(cfg, p, torch.tensor(u))
    if conv_dtype == "float32":
        _close(y, yf[:, -1:])


def test_init_state_matches_reference(block):
    cfg, jcfg, _, _, _ = block
    mine = ssm.mamba2_init_state(cfg, 3, torch.bfloat16, "cpu")
    ref = jax_ssm.mamba2_init_state(jcfg, 3, jnp.bfloat16)
    assert mine["conv"].dtype == torch.bfloat16
    assert mine["ssm"].dtype == torch.float32
    for key in ("conv", "ssm"):
        assert tuple(mine[key].shape) == ref[key].shape
        assert not mine[key].any()
