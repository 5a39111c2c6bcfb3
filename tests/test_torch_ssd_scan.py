"""The port's SSD chunk scan (shared B/C, the Mamba2 form) against the
reference's sequential oracle ``ssd_scan_ref``, its Pallas kernel in
interpret mode and its chunked jnp ``ssd_chunked``, on the same numpy
inputs: the sweep of tests/test_kernels.py plus P = 64 (zamba2's head
size), and a decay strong enough that e^{-cum} overflows float32.

Tolerance 3e-5 (atol and rtol), the reference's own for this sweep
(tests/test_kernels.py); 2e-2 for bfloat16 inputs.  On the CPU the
wrapper runs the plain version and launches nothing; the CUDA kernel
itself is checked on the card by tests/test_torch_cuda.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssd_scan.kernel import ssd_scan_pallas  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_seq  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_chunked  # noqa: E402
from repro_torch.kernels.ssd_scan import ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

TOL = 3e-5


def _inputs(B, S, H, P, N, seed=4, decay=0.2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            (-np.abs(rng.standard_normal((B, S, H))) * decay
             ).astype(np.float32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32),
            (rng.standard_normal((B, H, P, N)) * 0.1).astype(np.float32))


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 64, 3, 16, 8, 16),
    (1, 128, 2, 32, 16, 32),
    (2, 32, 1, 8, 8, 32),       # single chunk
    (2, 64, 2, 64, 16, 32),     # zamba2's head size P = 64
])
def test_plain_matches_reference_oracle_pallas_and_chunked(B, S, H, P, N,
                                                           chunk):
    arrays = _inputs(B, S, H, P, N)
    y, h = ops.ssd_scan(*(torch.tensor(a) for a in arrays), chunk=chunk)
    assert y.dtype == torch.float32 and y.shape == (B, S, H, P)
    assert h.dtype == torch.float32 and h.shape == (B, H, P, N)
    j = [jnp.asarray(a) for a in arrays]
    for want_y, want_h in (jax_seq(*j),
                           ssd_scan_pallas(*j, chunk=chunk, interpret=True),
                           jax_chunked(*j, chunk=chunk)):
        _close(y, want_y)
        _close(h, want_h)


def test_decay_past_float32_exponent_stays_finite():
    """-cum reaches ~300 inside a chunk of 128: e^{-cum} alone is inf in
    float32.  The decay is taken as e^{cum_q - cum_k}, masked above the
    diagonal first, so the result is finite and matches the sequential
    oracle."""
    arrays = _inputs(1, 128, 2, 16, 8, seed=6, decay=3.0)
    assert arrays[1].sum(axis=1).min() < -200
    y, h = ssd_scan_ref(*(torch.tensor(a) for a in arrays), chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want_y, want_h = jax_seq(*(jnp.asarray(a) for a in arrays))
    _close(y, want_y)
    _close(h, want_h)


def test_bfloat16_inputs_follow_the_float32_arithmetic():
    """bf16 x, a and B/C: the arithmetic stays f32, y comes back in
    x's type, the state in f32."""
    arrays = _inputs(2, 64, 2, 64, 16)
    t = [torch.tensor(a) for a in arrays]
    bf = [v.to(torch.bfloat16) for v in t[:4]] + [t[4]]
    y, h = ops.ssd_scan(*bf, chunk=32)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want_y, want_h = jax_seq(*(jnp.asarray(v.float().numpy()) for v in bf))
    _close(y, want_y, 2e-2)
    _close(h, want_h, 2e-2)


def test_ssd_chunked_goes_through_the_wrapper():
    arrays = _inputs(1, 64, 2, 64, 16)
    t = [torch.tensor(a) for a in arrays]
    n = ops.launches
    y, h = ssm.ssd_chunked(*t, chunk=128)        # Q = min(128, S) = 64
    assert ops.launches == n                     # CPU: the plain version
    want_y, want_h = jax_chunked(*(jnp.asarray(a) for a in arrays),
                                 chunk=128)
    _close(y, want_y)
    _close(h, want_h)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, a, b, c, h0 = (torch.tensor(v) for v in _inputs(1, 64, 2, 16, 8))
    with pytest.raises(NotImplementedError, match="per-head"):
        ops.ssd_scan(x, a, b[:, :, None].expand(1, 64, 2, 8).contiguous(),
                     c, h0)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(x, a, b, c, h0, chunk=48)
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(x, a, b, c, h0, chunk=48)
    with pytest.raises(ValueError, match="device"):
        ops.ssd_scan(*(v.to("meta") for v in (x, a, b, c, h0)))
    with pytest.raises(ValueError, match="different devices"):
        ops.ssd_scan(x, a, b, c, h0.to("meta"))
    with pytest.raises(TypeError, match="h0"):
        ops.ssd_scan(x, a, b, c, h0.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_scan(x, a, torch.tensor(_inputs(1, 64, 2, 16, 16)[2])[
            ..., ::2], c, h0)
    with pytest.raises(ValueError, match="shapes"):
        ops.ssd_scan(x, a[:, :32], b, c, h0)
