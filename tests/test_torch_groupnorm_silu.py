"""The port's fused GroupNorm+SiLU against the reference's Pallas kernel
(interpret mode) and its jnp oracle, on the same numpy inputs.

Tolerances are the reference's kernel-test ones (tests/test_kernels.py):
2e-5 in float32, 2e-2 in bfloat16.  On the CPU the wrapper runs the
plain version and launches nothing; the CUDA kernel itself is checked
on the card by tests/test_torch_cuda.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.groupnorm_silu.kernel import groupnorm_silu_pallas  # noqa: E402
from repro.kernels.groupnorm_silu.ref import groupnorm_silu_ref as jax_ref  # noqa: E402
from repro_torch.kernels.groupnorm_silu import ops  # noqa: E402
from repro_torch.kernels.groupnorm_silu.ref import groupnorm_silu_ref  # noqa: E402

# tests/test_kernels.py's sweep, plus two full-width CONFIG shapes
SHAPES = [(2, 8, 8, 32, 8), (1, 16, 16, 24, 6), (3, 4, 4, 16, 16),
          (2, 4, 4, 256, 32), (1, 16, 16, 384, 32)]
DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(B, H, W, C, seed=6):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, W, C)).astype(np.float32) * 2 + 0.5,
            rng.standard_normal(C).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


@pytest.mark.parametrize("B,H,W,C,G", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_reference(B, H, W, C, G, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    x, s, b = _inputs(B, H, W, C)
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(jdt)
    want_pallas = groupnorm_silu_pallas(xj, jnp.asarray(s), jnp.asarray(b),
                                        G, interpret=True)
    want_ref = jax_ref(xj, jnp.asarray(s), jnp.asarray(b), G)
    st, bt = torch.from_numpy(s), torch.from_numpy(b)
    before = ops.launches
    got_ref = groupnorm_silu_ref(xt, st, bt, G)
    got_op = ops.groupnorm_silu(xt, st, bt, G)
    assert ops.launches == before            # CPU: the plain version
    assert got_op.dtype == tdt and got_op.shape == xt.shape
    for got in (got_ref, got_op):
        for want in (want_pallas, want_ref):
            np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("bad", ["dtype", "rank", "layout", "scale"])
def test_wrapper_rejects_bad_inputs(bad):
    x, s, b = (torch.from_numpy(a) for a in _inputs(2, 4, 4, 16))
    if bad == "dtype":
        x = x.double()
    elif bad == "rank":
        x = x.reshape(2, 16, 16)
    elif bad == "layout":
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    else:
        s = s[:8]
    with pytest.raises((TypeError, ValueError)):
        ops.groupnorm_silu(x, s, b, 4)
