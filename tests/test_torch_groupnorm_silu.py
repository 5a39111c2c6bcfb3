"""The port's fused GroupNorm+SiLU against the reference's Pallas kernel
(interpret mode) and its jnp oracle, on the same numpy inputs.

Tolerances are the reference's kernel-test ones (tests/test_kernels.py):
2e-5 in float32, 2e-2 in bfloat16.  On the CPU the wrapper runs the
plain version and launches nothing; the CUDA kernel itself is checked
on the card by tests/test_torch_cuda.py.
"""

import math

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


# -- the kernel's launch plan (ops.plan), checked without a card -------------

# (H, W, C) of every gn_silu call of a full-width ddim-cifar10 forward
# (G = 32) and of SMOKE's (G = 8); tests/test_torch_cuda.py runs the
# kernel at the same lists.
UNET_GN = [(4, 4, 256), (4, 4, 512), (8, 8, 256), (8, 8, 512),
           (16, 16, 128), (16, 16, 256), (16, 16, 384), (16, 16, 512),
           (32, 32, 128), (32, 32, 256), (32, 32, 384)]
SMOKE_GN = [(8, 8, 32), (8, 8, 64), (8, 8, 96), (8, 8, 128), (16, 16, 32),
            (16, 16, 64), (16, 16, 96)]
PLAN_CASES = [(H, W, C, 32) for H, W, C in UNET_GN] + \
    [(H, W, C, 8) for H, W, C in SMOKE_GN]


@pytest.mark.parametrize("cfg_name", ["CONFIG", "SMOKE"])
def test_gn_shape_lists_are_the_forwards(cfg_name, monkeypatch):
    """The lists above are the shapes a forward gives gn_silu (traced on
    the meta device: shapes only, no arithmetic)."""
    from repro_torch.configs import ddim_cifar10
    from repro_torch.diffusion import unet
    from repro_torch.models.params import init_params
    cfg = getattr(ddim_cifar10, cfg_name)
    seen = set()

    def record(x, *a, **k):
        seen.add(tuple(x.shape[1:]))
        return x
    monkeypatch.setattr(unet, "gn_silu", record)
    monkeypatch.setattr(unet, "group_norm", lambda x, *a, **k: x)
    params = init_params(unet.schema(cfg), torch.Generator().manual_seed(0),
                         "meta")
    x = torch.zeros((1, cfg.image_size, cfg.image_size, cfg.in_channels),
                    device="meta")
    unet.forward(cfg, params, x, torch.zeros(1, device="meta"))
    assert sorted(seen) == (UNET_GN if cfg_name == "CONFIG" else SMOKE_GN)


@pytest.mark.parametrize("H,W,C,G", PLAN_CASES)
def test_plan_is_the_same_at_a_batch_and_its_bucket(H, W, C, G):
    """The bucketed engine runs a batch of B at shape_bucket(B): at every
    U-Net shape the kernel's tiling, and so each group's order of sums,
    is the same at both (the grid's batch axis only adds blocks)."""
    from repro_torch.core.execution import shape_bucket
    G = ops.num_groups_for(C, G)
    for B in range(1, 17):
        a = ops.plan(B, H * W, C, G, 4)
        b = ops.plan(shape_bucket(B), H * W, C, G, 4)
        assert (a.slab, a.threads, a.vec, a.nv, a.chunks) == \
            (b.slab, b.threads, b.vec, b.nv, b.chunks), B


@pytest.fixture
def fresh_plans():
    ops.plan.cache_clear()
    yield
    ops.plan.cache_clear()


@pytest.mark.parametrize("H,W,C,G", PLAN_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_tiles_whole_groups_on_chip(H, W, C, G, dtype, fresh_plans):
    eb = DTYPES[dtype][0].itemsize
    hw, cg = H * W, C // G
    for B in range(1, 17):
        p = ops.plan(B, hw, C, G, eb)
        rvec = p.slab // p.vec
        assert p.slab % cg == 0 and C % p.slab == 0        # whole groups
        assert p.vec * eb == 16 and p.slab * eb % 16 == 0  # 16-byte rows
        assert p.slab * eb >= min(ops.ROW_BYTES[-1], C * eb)
        assert p.tile_bytes == hw * p.slab * eb <= ops.ONCHIP_BYTES
        assert p.chunks == 1 and p.nv in ops.NV            # held on chip
        assert p.nv <= ops.NV_MAX[eb]
        assert p.nv * (p.threads // rvec) >= hw
        assert p.threads % rvec == 0 and p.threads <= ops.MAX_THREADS
        assert p.threads % 32 == 0                         # whole warps
        assert p.blocks == B * (C // p.slab)
        # the widest rows that fill the card, else as many blocks as
        # 32-byte rows give
        wider = [s for s in range(cg, C + 1, cg)
                 if C % s == 0 and s > p.slab and s * eb % 16 == 0]
        if p.blocks >= ops.SMS:
            assert all(B * (C // s) < ops.SMS or hw * s * eb
                       > ops.ONCHIP_BYTES or s * eb > ops.ROW_BYTES[0]
                       for s in wider)
        else:
            assert p.slab * eb <= max(ops.ROW_BYTES[-1],
                                      math.lcm(cg, p.vec) * eb)
        if B >= 8 and hw >= 256 and (H, W, C) in UNET_GN:
            unit = math.lcm(cg, p.vec)
            narrowest = next(s for s in range(unit, C + 1, unit)
                             if C % s == 0 and s * eb >= ops.ROW_BYTES[-1])
            assert p.blocks >= min(ops.SMS, B * (C // narrowest))


def test_plans_of_the_odd_card_shapes(fresh_plans):
    """The odd shapes of tests/test_torch_cuda.py reach the paths they
    are there for."""
    p = ops.plan(1, 99, 64, 32, 4)                  # a ragged last pass
    assert 99 % (p.threads // (p.slab // p.vec)) and p.chunks == 1
    p = ops.plan(2, 1089, 96, 32, 4)                # 288 threads to hold it
    assert p.slab == 12 and p.chunks == 1 and p.threads > ops.THREADS
    assert ops.plan(1, 25, 6, 3, 4).vec == 1                # 24-byte rows
    assert ops.plan(1, 65536, 32, 32, 4).chunks > 1         # not held
    assert ops.plan(2, 64, 64, 32, 4, aligned=False).vec == 1


def test_plan_refuses_groups_wider_than_a_block(fresh_plans):
    with pytest.raises(ValueError):
        ops.plan(1, 16, 8192, 1, 4)
