"""The port's flash attention against the reference's Pallas kernel
(interpret mode) and its jnp oracle, on the same numpy inputs, at the
sweeps of tests/test_kernels.py (MHA, GQA, MQA with a longer kv, D up
to 128; causal and not; windows 16, 48 and 64), zamba2's head size
D = 80, plus
``layers.chunked_attention`` against the reference's; and an emulation
of the CUDA kernel's 3xTF32 tensor-core products against the oracle.

Tolerances are the reference's kernel-test ones (tests/test_kernels.py):
2e-5 in float32, 2e-2 in bfloat16.  On the CPU the wrapper runs the
plain version and launches nothing; the CUDA kernel itself is checked
on the card by tests/test_torch_cuda.py.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro.models.layers import chunked_attention as jax_chunked  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _inputs(B, Sq, Skv, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, D)).astype(np.float32))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


def _both(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.tensor(a).to(tdt) for a in arrays],
            [jnp.asarray(a, jdt) for a in arrays])


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", [
    (1, 64, 64, 2, 2, 32),       # MHA
    (2, 64, 64, 4, 2, 64),       # GQA
    (1, 32, 128, 4, 1, 64),      # MQA, longer kv (ends aligned)
    (1, 128, 128, 2, 2, 128),
    (1, 64, 64, 8, 1, 64),       # TinyLlama's head geometry (G=8, D=64)
    (1, 64, 64, 4, 4, 80),       # zamba2's shared attention (G=1, D=80)
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_jax_ref_and_pallas(B, Sq, Skv, H, KV, D, causal,
                                          dtype):
    tol = DTYPES[dtype][2]
    (q, k, v), (jq, jk, jv) = _both(_inputs(B, Sq, Skv, H, KV, D), dtype)
    got = attention_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    for want in (jax_ref(jq, jk, jv, causal=causal),
                 flash_attention_pallas(jq, jk, jv, causal=causal, bq=32,
                                        bk=32, interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol)


def _tf32(x):
    """cvt.rna.tf32.f32 on float32 values: round the magnitude to 10
    mantissa bits, ties away from zero (+0x1000 on the bit pattern, then
    the low 13 bits cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _mm_3xtf32(a, b):
    """a @ b as the kernel's tensor cores take it: each operand split
    into hi = tf32(x) and lo = tf32(x - hi), lo*hi + hi*lo + hi*hi
    summed in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _emulated(q, k, v, causal, window, mm):
    """The CUDA kernel's arithmetic in numpy float32: scores by ``mm``,
    scaled by log2(e)/sqrt(D), masked entries p = 0, exp2, P V by
    ``mm``, divided by the row sum."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    qh = q.transpose(0, 2, 1, 3)
    kh, vh = (np.repeat(a.transpose(0, 2, 1, 3), H // KV, axis=1)
              for a in (k, v))
    s = mm(qh, kh.transpose(0, 1, 3, 2)) * np.float32(
        1.4426950408889634 / np.sqrt(D))
    qpos = np.arange(Sq)[:, None] + (Skv - Sq)
    kpos = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = np.where(mask, s, -np.inf).astype(np.float32)
    p = np.exp2(s - s.max(-1, keepdims=True)).astype(np.float32)
    o = mm(p, vh) / p.sum(-1, keepdims=True)
    return o.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", [
    (1, 64, 64, 2, 2, 32), (2, 64, 64, 4, 2, 64), (1, 32, 128, 4, 1, 64),
    (1, 128, 128, 2, 2, 128), (1, 64, 64, 8, 1, 64), (1, 64, 64, 4, 4, 80),
    (1, 128, 128, 32, 32, 80),   # zamba2's heads at the prefill length
    (1, 128, 128, 32, 4, 64),    # TinyLlama's
])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 48)])
def test_3xtf32_products_hold_the_float32_tolerance(B, Sq, Skv, H, KV, D,
                                                    causal, window):
    """Why the kernel splits every operand: with 3xTF32 products the
    kernel's arithmetic stays within the float32 tolerance (2e-5) of the
    JAX oracle; with plain TF32 (hi*hi alone) it does not."""
    q, k, v = _inputs(B, Sq, Skv, H, KV, D)
    want = _f32(jax_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window))
    got = _emulated(q, k, v, causal, window, _mm_3xtf32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    plain_tf32 = _emulated(q, k, v, causal, window, _mm_1xtf32)
    assert not np.allclose(plain_tf32, want, atol=2e-5, rtol=2e-5)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11,
                  -(1 + 2.0 ** -11), 1 + 2.0 ** -12, 3.0], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([1 + 2.0 ** -10, 1 + 2.0 ** -9,
                            -(1 + 2.0 ** -10), 1.0, 3.0], np.float32))
    hi = _tf32(x)
    np.testing.assert_array_equal(hi + _tf32(x - hi), x)


@pytest.mark.parametrize("window", [16, 48, 64])
def test_plain_matches_jax_window(window):
    """Windows whose start falls inside a 32-key block (16, 48) and on a
    block edge (64)."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 128, 128, 4, 2, 32, seed=1),
                                    "float32")
    got = attention_ref(q, k, v, causal=True, window=window)
    for want in (jax_ref(jq, jk, jv, causal=True, window=window),
                 flash_attention_pallas(jq, jk, jv, causal=True,
                                        window=window, bq=32, bk=32,
                                        interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("window", [0, 48])
def test_chunked_attention_matches_reference(window):
    """The model-level call: the port's chunked_attention (through the
    wrapper) against the reference's jnp chunked path (q_offset 0) at
    Sq == Skv, where its start alignment and the kernel's end alignment
    agree."""
    (q, k, v), (jq, jk, jv) = _both(_inputs(2, 96, 96, 8, 2, 64, seed=2),
                                    "float32")
    before = ops.launches
    got = layers.chunked_attention(q, k, v, causal=True, window=window)
    assert ops.launches == before
    want = jax_chunked(jq, jk, jv, causal=True, window=window, q_chunk=32,
                       kv_chunk=32)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


def test_chunked_attention_raises_for_cross_attention():
    """Sq != Skv under a causal or window mask (continuation attention)
    used to raise; it runs now and is held to the reference's jnp path
    in test_continuation_attention_matches_jnp_path.  What still raises
    is a negative q_offset; unmasked (cross attention) it runs, held to
    the reference in tests/test_torch_vlm.py."""
    q, k, v = (torch.tensor(a) for a in _inputs(1, 8, 16, 2, 2, 32))
    for kw in (dict(causal=True), dict(causal=False, window=4)):
        assert layers.chunked_attention(q, k, v, **kw).shape == q.shape
        with pytest.raises(ValueError, match="q_offset"):
            layers.chunked_attention(q, k, v, q_offset=-1, **kw)
    assert layers.chunked_attention(q, k, v, causal=False).shape == q.shape


# (Sq, Skv, q_offset, window): queries before, inside and past the keys;
# every row keeps a key (a row whose keys are all masked gets 0 from the
# kernel and the mean of v from the plain version)
CONTINUATION = [(8, 40, 0, 0), (8, 40, 32, 0), (8, 40, 13, 6),
                (40, 24, 0, 0), (40, 24, 0, 24), (24, 16, 5, 20),
                (32, 32, 7, 0), (32, 32, 7, 9)]


@pytest.mark.parametrize("Sq,Skv,q_offset,window", CONTINUATION)
@pytest.mark.parametrize("causal", [True, False])
def test_continuation_attention_matches_jnp_path(Sq, Skv, q_offset, window,
                                                 causal):
    """chunked_attention(q_offset=...) against the reference's jnp path
    with the same offset, causal or windowed (or both), at Sq < Skv,
    Sq > Skv and Sq == Skv (where its Pallas kernel would ignore the
    offset), within 2e-5; the wrapper's plain version on the CPU."""
    if not causal and not window:
        window = Skv                     # windowed only: a mask to hold
    arrays = _inputs(2, Sq, Skv, 8, 2, 64, seed=Sq + Skv + q_offset)
    (q, k, v), (jq, jk, jv) = _both(arrays, "float32")
    before = ops.launches
    got = layers.chunked_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, parallel_q=True)
    assert ops.launches == before
    for parallel_q in (False, True):
        want = jax_chunked(jq, jk, jv, causal=causal, window=window,
                           q_offset=q_offset, q_chunk=16, kv_chunk=16,
                           parallel_q=parallel_q)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5,
                                   rtol=2e-5)


def test_wrapper_runs_plain_version_on_cpu():
    q, k, v = (torch.tensor(a) for a in _inputs(2, 16, 16, 4, 2, 64, seed=3))
    before = ops.launches
    got = ops.flash_attention(q, k, v, causal=True, window=5)
    assert ops.launches == before
    torch.testing.assert_close(got, attention_ref(q, k, v, window=5),
                               atol=0, rtol=0)


def test_wrapper_rejects_bad_inputs():
    q, k, v = (torch.tensor(a) for a in _inputs(1, 16, 16, 4, 2, 64))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :, :1].expand(-1, -1, 3, -1)
                            .contiguous(), v)                 # H % KV
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :48].contiguous(),
                            k[..., :48].contiguous(),
                            v[..., :48].contiguous())         # head_dim 48
    with pytest.raises(ValueError):
        ops.flash_attention(torch.cat([q, q], 1), k, v)       # Sq > Skv
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.bfloat16(), v)               # mixed types
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), k, v)          # layout
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=-1)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", [
    (2, 64, 64, 4, 2, 64),       # GQA
    (1, 32, 128, 4, 1, 64),      # MQA, longer kv (ends aligned)
    (1, 64, 64, 8, 1, 64),       # TinyLlama's head geometry (G=8, D=64)
    (1, 64, 64, 4, 4, 80),       # zamba2's shared attention (G=1, D=80)
])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 24)])
def test_backward_matches_jax_vjp_of_the_reference(B, Sq, Skv, H, KV, D,
                                                   causal, window):
    """``flash_attention_backward`` (the card Function's backward)
    against ``jax.vjp`` of the reference's plain version, float32,
    2e-5; dk and dv come back in the GQA layout (B,Skv,KV,D)."""
    import jax
    arrays = _inputs(B, Sq, Skv, H, KV, D)
    do = np.random.default_rng(1).standard_normal(
        (B, Sq, H, D)).astype(np.float32)
    got = ops.flash_attention_backward(
        *(torch.tensor(a) for a in arrays), torch.tensor(do), causal=causal,
        window=window)
    _, vjp = jax.vjp(lambda q, k, v: jax_ref(q, k, v, causal=causal,
                                             window=window),
                     *(jnp.asarray(a) for a in arrays))
    for g, want, a in zip(got, vjp(jnp.asarray(do)), arrays):
        assert g.shape == a.shape == want.shape
        np.testing.assert_allclose(_f32(g), _f32(want), atol=2e-5,
                                   rtol=2e-5)
