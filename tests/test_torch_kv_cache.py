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


# -- layer-stacked in-place helpers (decode_inplace_cache) -------------------

LEAD = (2, 3)          # a stacked cache of 2 groups of 3 layers (the VLM's)


def _stacked(dtype, seed):
    """A (2, 3, B, S, KV, D) cache with every layer written, in both
    trees."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(LEAD + (B, S, KV, D)).astype(np.float32)
    jone, tone = jkv.alloc(B, S, KV, D, dtype), \
        kv_cache.alloc(B, S, KV, D, dtype, "cpu")

    def jstack(x):
        return jnp.broadcast_to(x, LEAD + x.shape)
    jc = jax_tree_map(jstack, jone)
    tc = ({k: v.expand(LEAD + v.shape).clone() for k, v in tone.items()}
          if isinstance(tone, dict) else tone.expand(LEAD + tone.shape).clone())
    zero = np.zeros(B, np.int32)
    for g in range(LEAD[0]):
        for i in range(LEAD[1]):
            jc = jkv.write_layer(jc, (g, i), jnp.asarray(base[g, i]),
                                 jnp.asarray(zero))
            kv_cache.write_layer(tc, (g, i), torch.tensor(base[g, i]),
                                 torch.tensor(zero))
    return jc, tc


def jax_tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    return fn(tree)


# (positions, S_new): rows at different places, past the end (dropped, or
# clamped when uniform), negative
LAYER_CASES = [([0, 3, 7], 1), ([5, 5, 5], 3), ([14, 2, 9], 2),
               ([15, 15, 0], 1), ([-2, 4, 1], 1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos,n", LAYER_CASES)
@pytest.mark.parametrize("uniform", [False, True])
def test_write_layer_matches(dtype, pos, n, uniform):
    """write_layer into one layer of a stacked cache, per-row scatter or
    (uniform) every row at pos[0] with the start clamped to [0, S - n]
    as lax.dynamic_update_slice clamps it: == the reference's, the other
    layers untouched; layer_view and read_layer of every layer ==."""
    jc, tc = _stacked(dtype, 5)
    new = np.random.default_rng(6).standard_normal(
        (B, n, KV, D)).astype(np.float32) * 2
    p = np.asarray(pos, np.int32)
    want = jkv.write_layer(jc, (1, 2), jnp.asarray(new), jnp.asarray(p),
                           uniform=uniform)
    got = kv_cache.write_layer(tc, (1, 2), torch.tensor(new),
                               torch.tensor(p), uniform=uniform)
    assert got is tc                       # in place
    _equal(got, want)
    for g in range(LEAD[0]):
        for i in range(LEAD[1]):
            _equal(kv_cache.layer_view(got, (g, i)),
                   jkv.layer_view(want, (g, i)))
            _equal(kv_cache.read_layer(got, (g, i)),
                   jkv.read_layer(want, (g, i)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_view_is_a_view(dtype):
    _, tc = _stacked(dtype, 7)
    view = kv_cache.layer_view(tc, (0, 1))
    new = torch.full((B, 1, KV, D), 3.0)
    kv_cache.write_layer(view, (), new, torch.tensor([1, 2, 3]))
    _equal(kv_cache.layer_view(tc, (0, 1)), view)
    row = (tc["q"] if dtype == "int8" else tc)[0, 1, 0, 1]
    assert float(row.float().abs().max()) > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("start,w", [(0, 4), (5, 4), (12, 4), (14, 4),
                                     (-3, 5), (0, 16)])
def test_slice_window_matches(dtype, start, w):
    """slice_window of one layer, start clamped to [0, S - w] as
    lax.dynamic_slice_in_dim clamps it, from an int or a 0-d tensor:
    == the reference's, and contiguous."""
    jc, tc = _stacked(dtype, 8)
    want = jkv.slice_window(jkv.layer_view(jc, (1, 0)), jnp.int32(start), w)
    for s in (start, torch.tensor(start)):
        got = kv_cache.slice_window(kv_cache.layer_view(tc, (1, 0)), s, w)
        _equal(got, want)
        for t in (got.values() if isinstance(got, dict) else [got]):
            assert t.is_contiguous()
