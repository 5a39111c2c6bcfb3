"""The port's flash-decode attention against the reference's Pallas
kernel (interpret mode) and its jnp oracle, on the same numpy inputs,
at the sweep of tests/test_kernels.py (MHA, GQA, MQA; windows 0 and 64;
float32 and bfloat16) plus zamba2's head size (D = 80, G = 1) and granite's multi-query group (G = 48), windows 16 and 48 (starts inside a block), the
mixed float32-q / bfloat16-cache case the serving path runs, and
``layers.decode_attention`` against the reference's model path.

Tolerances are the reference's kernel-test ones (tests/test_kernels.py):
2e-5 in float32, 2e-2 when bfloat16 is involved (and against the JAX
model path, which casts p to the cache's type before the PV product).
cur_len is drawn >= 1, as in the reference's tests: with 0 the oracles
give the mean of v and the kernels 0 (see the port's ref.py).  On the
CPU the wrapper runs the plain version and launches nothing; the CUDA
kernel itself is checked on the card by tests/test_torch_cuda.py.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref  # noqa: E402
from repro.models.layers import decode_attention as jax_model  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, S, H, KV, D, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, 1, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            np.random.default_rng(0).integers(1, S + 1, B).astype(np.int32))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else
                      jnp.asarray(a, jnp.float32), np.float32)


def _run(shape, window, q_dtype, c_dtype, bs, seed=3):
    q, kc, vc, cur = _inputs(*shape, seed=seed)
    got = decode_attention_ref(torch.tensor(q).to(TDT[q_dtype]),
                               torch.tensor(kc).to(TDT[c_dtype]),
                               torch.tensor(vc).to(TDT[c_dtype]),
                               torch.tensor(cur), window=window)
    jargs = (jnp.asarray(q, JDT[q_dtype]), jnp.asarray(kc, JDT[c_dtype]),
             jnp.asarray(vc, JDT[c_dtype]), jnp.asarray(cur))
    return got, (jax_ref(*jargs, window=window),
                 decode_attention_pallas(*jargs, window=window, bs=bs,
                                         interpret=True))


SWEEP = [((2, 256, 4, 2, 64), 64), ((1, 128, 8, 8, 32), 32),
         ((3, 512, 4, 1, 128), 128),
         ((2, 128, 4, 4, 80), 32),          # zamba2's head size, G=1
         ((2, 128, 48, 1, 128), 64)]        # granite's multi-query, G=48


@pytest.mark.parametrize("shape,bs", SWEEP)
@pytest.mark.parametrize("window", [0, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_ref_and_pallas(shape, bs, window, dtype):
    got, wants = _run(shape, window, dtype, dtype, bs)
    B, _, H, _, D = shape
    assert got.dtype == TDT[dtype] and got.shape == (B, 1, H, D)
    tol = 2e-5 if dtype == "float32" else 2e-2
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("window", [0, 16, 48])
def test_mixed_f32_q_bf16_cache_matches(window):
    """The serving path's default: float32 q over a bfloat16 cache, at
    TinyLlama's head geometry (H=32, KV=4, D=64); output float32."""
    got, wants = _run((2, 256, 32, 4, 64), window, "float32", "bfloat16",
                      64, seed=5)
    assert got.dtype == torch.float32
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2,
                                   rtol=2e-2)


@pytest.mark.parametrize("window", [16, 48])
def test_windows_starting_inside_a_block(window):
    got, wants = _run((3, 256, 8, 2, 64), window, "float32", "float32", 64,
                      seed=6)
    for want in wants:
        np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("c_dtype", ["float32", "bfloat16"])
def test_layer_decode_attention_matches_jax_model_path(c_dtype):
    """layers.decode_attention (through the wrapper) against the
    reference's jnp model path, which casts p to the cache's type."""
    q, kc, vc, cur = _inputs(2, 128, 8, 2, 64, seed=7)
    before = ops.launches
    got = layers.decode_attention(torch.tensor(q),
                                  torch.tensor(kc).to(TDT[c_dtype]),
                                  torch.tensor(vc).to(TDT[c_dtype]),
                                  torch.tensor(cur))
    assert ops.launches == before
    want = jax_model(jnp.asarray(q), jnp.asarray(kc, JDT[c_dtype]),
                     jnp.asarray(vc, JDT[c_dtype]), jnp.asarray(cur))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-2, rtol=2e-2)


def test_wrapper_runs_plain_version_on_cpu_and_takes_an_int_length():
    q, kc, vc, _ = (torch.tensor(a) for a in _inputs(2, 64, 4, 2, 32))
    before = ops.launches
    got = ops.decode_attention(q, kc, vc, 17, window=8)
    assert ops.launches == before
    want = decode_attention_ref(q, kc, vc, torch.full((2,), 17), window=8)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_zero_length_row_gives_mean_of_v_in_the_plain_version():
    """Documented difference: the oracle gives the mean of v for
    cur_len 0, the kernels 0.  The serving path never passes 0."""
    q, kc, vc, _ = (torch.tensor(a) for a in _inputs(1, 16, 2, 2, 32))
    got = ops.decode_attention(q, kc, vc, torch.tensor([0]))
    torch.testing.assert_close(got[0, 0], vc[0].mean(0), atol=1e-6,
                               rtol=1e-6)


def test_wrapper_rejects_bad_inputs():
    q, kc, vc, cur = (torch.tensor(a) for a in _inputs(2, 64, 4, 2, 64))
    with pytest.raises(ValueError):
        ops.decode_attention(torch.cat([q, q], 1), kc, vc, cur)  # 2 tokens
    with pytest.raises(TypeError):
        ops.decode_attention(q, kc, vc.bfloat16(), cur)          # k != v type
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc, vc, cur[:1])                 # cur shape
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc[..., :48].contiguous(),
                             vc[..., :48].contiguous(), cur)     # D mismatch
    with pytest.raises(ValueError):
        ops.decode_attention(q, kc.transpose(1, 2), vc, cur)     # layout


@pytest.mark.parametrize("B,KV,S", [(1, 1, 1), (1, 4, 64), (1, 4, 65),
                                    (8, 4, 512), (1, 4, 512), (16, 4, 512),
                                    (8, 32, 512), (1, 32, 512), (1, 4, 4096),
                                    (64, 32, 4096), (3, 7, 1000),
                                    (2, 1, 0)])
def test_num_splits_fills_the_card_within_the_cache(B, KV, S):
    """The split count is a function of shapes alone: at least 1, at
    most one split per 64-row tile of the cache, and enough splits for
    BLOCK_TARGET blocks over the B * KV pairs wherever the cache has
    that many tiles."""
    n = ops.num_splits(B, KV, S)
    tiles = -(-S // ops.TILE)
    assert isinstance(n, int) and 1 <= n <= max(1, tiles)
    if B * KV * tiles >= ops.BLOCK_TARGET:
        assert B * KV * n >= ops.BLOCK_TARGET
    else:
        assert n == max(1, tiles)
    assert n == ops.num_splits(B, KV, S)          # no state, no device


def test_num_splits_at_the_serving_path_shapes():
    """TinyLlama (KV = 4) over a 512-row cache: 8 splits at B = 8 (256
    blocks, not 32) and at B = 1 (32, not 4); Zamba2 (KV = 32): 2 at
    B = 8, 8 at B = 1."""
    assert ops.num_splits(8, 4, 512) == 8
    assert ops.num_splits(1, 4, 512) == 8
    assert ops.num_splits(8, 32, 512) == 2
    assert ops.num_splits(1, 32, 512) == 8


@pytest.mark.parametrize("window", [0, 16])
def test_decode_wrapper_takes_any_group(window):
    """G = 48 and G = 96 (two blocks of heads a KV head on the card) go
    through the wrapper's checks; on the CPU the plain version runs."""
    rng = np.random.default_rng(3)
    for H, KV in ((48, 1), (96, 1), (96, 2)):
        q = torch.tensor(rng.standard_normal((2, 1, H, 64)),
                         dtype=torch.float32)
        kc = torch.tensor(rng.standard_normal((2, 64, KV, 64)),
                          dtype=torch.float32)
        vc = torch.tensor(rng.standard_normal((2, 64, KV, 64)),
                          dtype=torch.float32)
        cur = torch.tensor([40, 64], dtype=torch.int32)
        before = ops.launches
        got = ops.decode_attention(q, kc, vc, cur, window=window)
        assert ops.launches == before
        want = decode_attention_pallas(
            jnp.asarray(q.numpy()), jnp.asarray(kc.numpy()),
            jnp.asarray(vc.numpy()), jnp.asarray(cur.numpy()),
            window=window, bs=64, interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    f32 = torch.float32
    assert ops.plan(2, 64, 48, 1, 64, f32, f32).chunks == 3
    assert ops.plan(2, 64, 96, 1, 64, f32, f32).chunks == 6
    assert ops.plan(2, 64, 96, 2, 64, f32, f32).grid == (
        ops.plan(2, 64, 96, 2, 64, f32, f32).splits, 6, 2)


# -- the split pass's plan (shapes only) ------------------------------------

F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("G,D,path", [
    (1, 80, "cuda-core"), (1, 128, "cuda-core"), (3, 128, "cuda-core"),
    (7, 128, "cuda-core"), (8, 64, "cuda-core"), (8, 80, "cuda-core"),
    (8, 32, "cuda-core"), (8, 128, "tensor"), (9, 32, "tensor"),
    (16, 64, "tensor"), (24, 80, "tensor"), (33, 64, "tensor"),
    (48, 128, "tensor"), (64, 128, "tensor"), (96, 32, "tensor")])
def test_path_rule(G, D, path):
    """Tensor cores for every group of more than 8 heads and for 8 over
    rows of 128; the CUDA-core kernel (at most 8 heads a block) for the
    rest.  The plan follows the rule at any B and S, whatever the
    types."""
    assert ops.tensor_path(G, D) == (path == "tensor")
    for q_dt, c_dt in ((F32, F32), (BF16, BF16), (F32, BF16)):
        for B, S in ((1, 64), (8, 512), (16, 1601)):
            p = ops.plan(B, S, G * 2, 2, D, q_dt, c_dt)
            assert p.path == path
            assert p.heads == (min(G, 8) if path == "cuda-core"
                               else ops.tc_heads(G))


# (name, (B, S, H, KV, D), path, heads, chunks, splits, resident) at f32 q
# over a bf16 cache, the serving path's types
SERVING = [
    ("tinyllama", (8, 512, 32, 4, 64), "cuda-core", 8, 1, 8, 0),
    ("zamba2", (8, 512, 32, 32, 80), "cuda-core", 1, 1, 2, 0),
    ("minitron", (8, 512, 24, 8, 128), "cuda-core", 3, 1, 5, 0),
    ("qwen3", (8, 512, 32, 4, 128), "tensor", 8, 1, 8, 2),
    ("vlm self", (8, 512, 64, 8, 128), "tensor", 8, 1, 4, 2),
    ("vlm cross", (8, 1601, 64, 8, 128), "tensor", 8, 1, 4, 2),
    ("granite", (8, 512, 48, 1, 128), "tensor", 16, 3, 8, 3),
    ("granite B=1", (1, 512, 48, 1, 128), "tensor", 16, 3, 8, 3),
    ("vlm cross B=1", (1, 1601, 64, 8, 128), "tensor", 8, 1, 26, 2)]


@pytest.mark.parametrize("name,shape,path,heads,chunks,splits,resident",
                         SERVING, ids=[r[0] for r in SERVING])
def test_plan_at_the_serving_path_shapes(name, shape, path, heads, chunks,
                                         splits, resident):
    """The split pass of each serving path's decode call.  On the
    tensor-core path the grid is at most one wave of resident blocks and
    no split holds less than TC_SPLIT_ROWS rows of a full cache: the
    VLM's cross call 4 splits, 256 blocks of the 264 that fit (2 an SM
    at 110,592 bytes each), granite 8 splits, 192 blocks (3 an SM fit
    at 64,512 bytes: 396 places), at B = 1 as many as 64-row shares of
    the cache allow."""
    B, S, H, KV, D = shape
    p = ops.plan(B, S, H, KV, D, F32, BF16)
    assert (p.path, p.heads, p.chunks, p.splits, p.resident) == (
        path, heads, chunks, splits, resident)
    assert p.grid == (splits, KV * chunks, B)
    if path == "tensor":
        assert p.granule == ops.GRANULE == 16
        assert p.rows == 16 * ops.TC_WARPS // (heads // 8)
        assert p.smem == ops.tc_smem(D, 4, 2, heads) <= 232448
        assert math.prod(p.grid) <= ops.SMS * p.resident or p.splits == 1
        assert p.splits <= -(-S // ops.TC_SPLIT_ROWS)
    else:
        assert (p.rows, p.granule) == (ops.TILE, ops.TILE)
        assert p.splits == ops.num_splits(B, KV, S)
    assert ops.plan(B, S, H, KV, D, F32, BF16) is p      # shapes only


def test_tensor_path_shared_memory_and_residency():
    """The tensor-core block's shared memory, as the kernel's TcLayout
    computes it: the VLM's 110,592 bytes (q in three bf16 parts, 6 KiB;
    a three-stage ring of 64-row k and v tiles at 17 chunks a row: 2
    blocks an SM), granite's 64,512 (16 heads, 32-row tiles: 3); an
    f32 cache's wider rows (TF32 hi and lo of q) hold fewer blocks; a
    bf16 q is one part."""
    assert ops._stride(128, 2) == 17 and ops._stride(80, 2) == 11
    assert ops._stride(64, 4) == 18 and ops._stride(32, 2) == 5
    assert ops._stride(80, 4) == 22 and ops._stride(128, 4) == 34
    assert ops.tc_smem(128, 4, 2, 8) == 6144 + 3 * 64 * 34 * 16 == 110592
    assert ops.tc_smem(128, 4, 2, 16) == 12288 + 3 * 32 * 34 * 16 == 64512
    assert ops.tc_smem(128, 2, 2, 8) == 2048 + 104448
    assert ops.tc_smem(128, 4, 4, 8) == 8192 + 3 * 64 * 68 * 16
    assert ops.plan(8, 1601, 64, 8, 128, F32, F32).resident == 1
    assert ops.plan(8, 1601, 64, 8, 128, BF16, BF16).resident == 2
    for D in ops.HEAD_DIMS:
        for q_b in (2, 4):
            for c_b in (2, 4):
                for hb in (8, 16):
                    assert ops.tc_smem(D, q_b, c_b, hb) <= 232448


def _granules(shares, granule):
    return [u for sh in shares if sh for u in range(sh[0] // granule,
                                                    -(-sh[1] // granule))]


@pytest.mark.parametrize("name,shape", [(r[0], r[1]) for r in SERVING]
                         + [("block", (1, 262144, 32, 4, 64)),
                            ("G96", (8, 200, 96, 1, 32))],
                         ids=[r[0] for r in SERVING] + ["block", "G96"])
def test_splits_cover_every_tile_exactly_once(name, shape):
    """At cur_len = S the planned splits take every granule of the
    cache exactly once, in order, in shares that differ by at most one
    granule; at any valid range [lo, hi) they take exactly the granules
    that overlap it, each share clipped to it."""
    B, S, H, KV, D = shape
    p = ops.plan(B, S, H, KV, D, F32, BF16)
    full = ops.split_shares(p.splits, p.granule, 0, S)
    assert _granules(full, p.granule) == list(range(-(-S // p.granule)))
    sizes = [-(-(b - a) // p.granule) if (a, b) != (0, 0) else 0
             for a, b in (sh or (0, 0) for sh in full)]
    assert max(sizes) - min(sizes) <= 1
    rng = np.random.default_rng(len(name))
    for _ in range(50):
        lo, hi = sorted(int(x) for x in rng.integers(0, S + 1, 2))
        shares = ops.split_shares(p.splits, p.granule, lo, hi)
        assert len(shares) == p.splits
        units = _granules(shares, p.granule)
        want = list(range(lo // p.granule, -(-hi // p.granule))) \
            if hi > lo else []
        assert units == want
        rows = [r for sh in shares if sh for r in range(*sh)]
        assert rows == list(range(lo, hi))


def test_cost_takes_the_rate_of_the_kernels_products():
    """``cost`` prices a call's operations at the rate of the products
    its kernel runs: on the tensor-core path three bfloat16 products per
    product for float32 q over a bfloat16 cache, 3xTF32 over a float32
    cache, one bfloat16 product for bfloat16 q over a bfloat16 cache;
    on the CUDA-core path float32 at F32_OPS_PER_S.  The block variant
    prices the same way."""
    from repro_torch.kernels import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                     TF32_OPS_PER_S)

    def rate(H, KV, D, q_dt, c_dt):
        q = torch.empty(8, 1, H, D, dtype=q_dt, device="meta")
        k = torch.empty(8, 512, KV, D, dtype=c_dt, device="meta")
        c, b = ops.cost(q, k, k), ops.cost_block(q, k, k)
        assert (c.ops_per_s, c.per_op) == (b.ops_per_s, b.per_op)
        return c.ops_per_s, c.per_op
    assert rate(48, 1, 128, F32, BF16) == (BF16_OPS_PER_S, 3)     # granite
    assert rate(64, 8, 128, F32, BF16) == (BF16_OPS_PER_S, 3)     # the VLM
    assert rate(48, 1, 128, F32, F32) == (TF32_OPS_PER_S, 3)
    assert rate(48, 1, 128, BF16, F32) == (TF32_OPS_PER_S, 3)
    assert rate(48, 1, 128, BF16, BF16) == (BF16_OPS_PER_S, 1)
    assert rate(32, 4, 64, F32, BF16) == (F32_OPS_PER_S, 1)       # TinyLlama
    assert rate(24, 8, 128, F32, F32) == (F32_OPS_PER_S, 1)       # minitron
    assert rate(32, 4, 64, BF16, BF16) == (BF16_OPS_PER_S, 1)
