"""The port's KV-cache helpers against ``repro.models.kv_cache`` on the
same inputs: ``alloc``, ``write`` (drop mode: positions counted from
the end for [-S, 0), dropped outside [-S, S)) and ``read``, for the
bfloat16, float32 and int8 caches.  Results are compared with ``==``:
the same roundings (f32 -> bf16 to nearest even, int8 by round-half-
even of the same f32 quotient) give the same bits."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import kv_cache as jkv  # noqa: E402
from repro_torch.models import kv_cache  # noqa: E402

B, S, KV, D = 3, 16, 2, 8
DTYPES = ["bfloat16", "float32", "int8"]


def _np(a):
    if isinstance(a, dict):
        return {k: _np(v) for k, v in a.items()}
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    return np.asarray(jnp.asarray(a, jnp.float32)
                      if a.dtype == jnp.bfloat16 else a)


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
        return
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_alloc_matches(dtype):
    got = kv_cache.alloc(B, S, KV, D, dtype, "cpu")
    want = jkv.alloc(B, S, KV, D, dtype)
    _equal(got, want)
    dt = (got["q"] if dtype == "int8" else got).dtype
    assert str(dt).endswith({"bfloat16": "bfloat16", "float32": "float32",
                             "int8": "int8"}[dtype])


# (positions, S_new): in range, running past the end, negative (counted
# from the end), below -S (dropped), longer than the cache
CASES = [([0, 3, 7], 4), ([12, 14, 15], 4), ([-2, 5, -17], 3),
         ([0, 0, 0], 1), ([-20, 15, 3], 1), ([0, 2, 9], 20)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos,n", CASES)
def test_write_and_read_match(dtype, pos, n):
    rng = np.random.default_rng(len(pos) * 7 + n)
    new = rng.standard_normal((B, n, KV, D)).astype(np.float32) * 3
    base = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    jc = jkv.write(jkv.alloc(B, S, KV, D, dtype),
                   jnp.asarray(base), jnp.zeros(B, jnp.int32))
    tc = kv_cache.write(kv_cache.alloc(B, S, KV, D, dtype, "cpu"),
                        torch.tensor(base), torch.zeros(B, dtype=torch.int32))
    _equal(tc, jc)
    p = np.asarray(pos, np.int32)
    want = jkv.write(jc, jnp.asarray(new), jnp.asarray(p))
    before = _np(tc)
    got = kv_cache.write(tc, torch.tensor(new), torch.tensor(p))
    _equal(got, want)
    _equal(kv_cache.read(got), jkv.read(want))
    _equal(tc, jc)
    if not isinstance(before, dict):     # write left its input as it was
        np.testing.assert_array_equal(_np(tc), before)


@pytest.mark.parametrize("dtype", DTYPES)
def test_write_with_shared_index_matches_write(dtype):
    """A decode step computes the write slots once and reuses them for
    every layer: the same result as ``write``."""
    rng = np.random.default_rng(3)
    new = torch.tensor(rng.standard_normal((B, 1, KV, D)).astype(np.float32))
    pos = torch.tensor([1, 15, -1], dtype=torch.int32)
    want = kv_cache.write(kv_cache.alloc(B, S, KV, D, dtype, "cpu"), new,
                          pos)
    got = kv_cache.write_(kv_cache.alloc(B, S, KV, D, dtype, "cpu"), new,
                          pos, kv_cache.write_index(pos, 1, S))
    _equal(got, want)


def test_write_index_rejects_more_positions_than_slots():
    with pytest.raises(ValueError):
        kv_cache.write_index(torch.zeros(2, dtype=torch.int32), S + 1, S)
