"""The port's RMSNorm against the reference's Pallas kernel (interpret
mode) and its jnp oracle, on the same numpy inputs, at the sweep of
tests/test_kernels.py plus TinyLlama's width.

Tolerances are the reference's kernel-test ones (tests/test_kernels.py):
2e-5 in float32, 2e-2 in bfloat16.  On the CPU the wrapper runs the
plain version and launches nothing; the CUDA kernel itself is checked
on the card by tests/test_torch_cuda.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.rmsnorm.kernel import rmsnorm_pallas  # noqa: E402
from repro.kernels.rmsnorm.ref import rmsnorm_ref as jax_ref  # noqa: E402
from repro.models.layers import rmsnorm as jax_layer_rmsnorm  # noqa: E402
from repro_torch.kernels.rmsnorm import ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

SHAPES = [(4, 64), (3, 7, 96), (2, 5, 3, 128), (1, 256), (2, 3, 2048)]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape[-1:]).astype(np.float32))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_ref_and_pallas(shape, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    x, s = _inputs(shape)
    got = rmsnorm_ref(torch.tensor(x).to(tdt), torch.tensor(s).to(tdt))
    assert got.dtype == tdt and got.shape == shape
    jx, js = jnp.asarray(x, jdt), jnp.asarray(s, jdt)
    for want in (jax_ref(jx, js), rmsnorm_pallas(jx, js, block_rows=4,
                                                 interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("xdt,sdt", [("float32", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_plain_matches_jax_ref_mixed_types(xdt, sdt):
    x, s = _inputs((6, 128), seed=2)
    got = rmsnorm_ref(torch.tensor(x).to(DTYPES[xdt][0]),
                      torch.tensor(s).to(DTYPES[sdt][0]))
    want = jax_ref(jnp.asarray(x, DTYPES[xdt][1]),
                   jnp.asarray(s, DTYPES[sdt][1]))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_layer_rmsnorm_goes_through_the_wrapper_and_matches():
    """layers.rmsnorm is the reference's layers.rmsnorm (the model's 45
    norms per TinyLlama forward) through the wrapper."""
    x, s = _inputs((2, 5, 256), seed=3)
    before = ops.launches
    got = layers.rmsnorm(torch.tensor(x), torch.tensor(s))
    assert ops.launches == before            # CPU: plain version
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_layer_rmsnorm(jnp.asarray(x),
                                                  jnp.asarray(s))),
        atol=2e-5, rtol=2e-5)


def test_wrapper_runs_plain_version_on_cpu():
    x, s = (torch.tensor(a) for a in _inputs((3, 4, 64), seed=4))
    before = ops.launches
    got = ops.rmsnorm(x, s, eps=1e-5)
    assert ops.launches == before
    torch.testing.assert_close(got, rmsnorm_ref(x, s, 1e-5), atol=0, rtol=0)


def test_wrapper_rejects_bad_inputs():
    x = torch.randn(4, 64)
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.ones(32))                       # wrong width
    with pytest.raises(TypeError):
        ops.rmsnorm(x.double(), torch.ones(64))              # float64
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.randn(64, 4).T, torch.ones(64))    # not contiguous
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.ones(64, device="meta"))        # other device


# -- the kernel's plan (ops.plan), checked without a card ---------------------

PATH_WIDTHS = (2048, 2560, 5120)     # TinyLlama d; Zamba2 d and d_inner
PLAN_WIDTHS = PATH_WIDTHS + (64, 96, 100, 128, 256, 10000, 16388, 40000)


@pytest.mark.parametrize("d", PLAN_WIDTHS)
@pytest.mark.parametrize("elem_bytes", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_holds_the_row_in_whole_warps(d, elem_bytes, aligned):
    p = ops.plan(d, elem_bytes, aligned)
    full = 16 // elem_bytes
    assert p.vec == (full if aligned and d % full == 0 else 1)
    assert p.nv in ops.NV and (p.vec == 1 or p.nv >= 2)
    assert p.threads % 32 == 0
    assert 64 <= p.threads <= ops.max_threads(p.nv, p.vec) <= 1024
    held = p.threads * p.nv * p.vec
    if p.chunks == 1:
        assert held >= d                     # the whole row in registers
        assert held - d < p.threads * p.vec or p.threads == 64
    else:                                    # no block holds it: chunks
        assert held * (p.chunks - 1) < d <= held * p.chunks
        assert held == max(ops.max_threads(n, p.vec) * n
                           for n in ops.NV) * p.vec


@pytest.mark.parametrize("elem_bytes,want", [
    (4, {2048: (128, 4), 2560: (160, 4), 5120: (320, 4)}),
    (2, {2048: (64, 4), 2560: (64, 5), 5120: (160, 4)})])
def test_plan_at_the_path_widths_has_no_idle_lane(elem_bytes, want):
    """Every path width is held whole with no idle lane, 4 vectors a
    thread where that divides the row."""
    for d in PATH_WIDTHS:
        p = ops.plan(d, elem_bytes)
        assert (p.threads, p.nv) == want[d] and p.chunks == 1
        assert p.threads * p.nv * p.vec == d
        q = ops.plan(d, elem_bytes, aligned=False)       # scalar loads
        assert q.vec == 1 and q.chunks == 1 and q.threads * q.nv == d


@pytest.mark.parametrize("shape", SHAPES)
def test_backward_matches_jax_vjp_of_the_reference(shape):
    """``rmsnorm_backward`` (the card Function's backward) against
    ``jax.vjp`` of the reference's plain version, float32, 2e-5."""
    import jax
    x, s = _inputs(shape)
    dy = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    dx, ds = ops.rmsnorm_backward(torch.tensor(x), torch.tensor(s),
                                  torch.tensor(dy))
    _, vjp = jax.vjp(jax_ref, jnp.asarray(x), jnp.asarray(s))
    want_dx, want_ds = vjp(jnp.asarray(dy))
    for got, want in ((dx, want_dx), (ds, want_ds)):
        assert got.shape == want.shape
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5,
                                   rtol=2e-5)
