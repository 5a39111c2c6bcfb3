"""The port's U-Net against ``repro.diffusion.unet`` on the same params
and inputs.

Params come from the reference's ``init_params`` and cross through
``params_from_numpy``.  Its ``conv_out`` is initialised at scale 1e-10,
which makes every eps ~0 and any comparison pass trivially, so the
parity tests redraw it (one numpy draw, scale 1/sqrt(fan_in), handed to
both sides).

Forward tolerance: atol = rtol = 1e-4.  Both sides compute in float32
but sum in different orders (XLA's and ATen's convolutions, over ~20
layers); PERF.md records the measured error.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ddim_cifar10 as jax_cfgs  # noqa: E402
from repro.diffusion import unet as jax_unet  # noqa: E402
from repro.models.params import init_params as jax_init  # noqa: E402
from repro_torch.configs import ddim_cifar10 as cfgs  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.models.params import P, init_params  # noqa: E402
from repro_torch.models.params import map_schema, params_from_numpy  # noqa: E402

SMOKE = cfgs.SMOKE
CPU = torch.device("cpu")


def redrawn_params(cfg, seed=0):
    """The reference's params with conv_out redrawn (numpy)."""
    params = jax.tree_util.tree_map(
        np.asarray, jax_init(jax_unet.schema(cfg), jax.random.PRNGKey(seed)))
    shape = params["conv_out"].shape                 # HWIO
    rng = np.random.default_rng(seed + 100)
    params["conv_out"] = (rng.standard_normal(shape)
                          / np.sqrt(shape[2])).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def smoke_params():
    return redrawn_params(SMOKE)


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_config_copy_equals_reference(name):
    assert dataclasses.asdict(getattr(cfgs, name)) == \
        dataclasses.asdict(getattr(jax_cfgs, name))


@pytest.mark.parametrize("cfg", [cfgs.SMOKE, cfgs.CONFIG],
                         ids=lambda c: c.name)
def test_params_from_numpy_covers_every_leaf(cfg):
    """Every leaf of the reference schema lands on the port's schema,
    HWIO convolutions as OIHW; the parameter counts agree."""
    ref_schema = jax_unet.schema(cfg)
    ref_leaves = jax.tree_util.tree_leaves(
        ref_schema, is_leaf=lambda x: hasattr(x, "axes"))
    ref_tree = jax.tree_util.tree_map(
        lambda p: np.zeros(p.shape, np.float32), ref_schema,
        is_leaf=lambda x: hasattr(x, "axes"))
    port = params_from_numpy(unet.schema(cfg), ref_tree, CPU)
    port_leaves = []
    map_schema(lambda p, path: port_leaves.append(p), unet.schema(cfg))
    assert len(port_leaves) == len(ref_leaves)
    n = sum(int(np.prod(p.shape)) for p in port_leaves)
    assert n == sum(int(t.numel()) for t in jax.tree_util.tree_leaves(port))
    assert n == sum(int(np.prod(p.shape)) for p in ref_leaves)
    if cfg is cfgs.CONFIG:
        assert n == 35_719_680
    assert tuple(port["conv_in"].shape) == (cfg.base_channels,
                                            cfg.in_channels, 3, 3)


def test_params_from_numpy_rejects_mismatches(smoke_params):
    s = unet.schema(SMOKE)
    extra = dict(smoke_params, bogus=np.zeros(3))
    with pytest.raises(KeyError):
        params_from_numpy(s, extra, CPU)
    missing = {k: v for k, v in smoke_params.items() if k != "temb1"}
    with pytest.raises(KeyError):
        params_from_numpy(s, missing, CPU)
    wrong = dict(smoke_params, temb1=np.zeros((3, 3), np.float32))
    with pytest.raises(ValueError):
        params_from_numpy(s, wrong, CPU)


def test_init_params_follows_schema():
    s = unet.schema(SMOKE)
    params = init_params(s, torch.Generator().manual_seed(0), CPU)

    def check(p: P, path):
        t = params
        for key in path.strip("/").split("/"):
            t = t[int(key)] if isinstance(t, list) else t[key]
        assert tuple(t.shape) == p.shape, path
        if p.init == "ones":
            assert bool((t == 1).all()), path
    map_schema(check, s)
    assert float(params["conv_out"].abs().max()) < 1e-8   # scale 1e-10


def forward_pair(params_np):
    """(port, reference) eps on SMOKE, B=3, mixed timesteps."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    t = np.array([0.0, 417.0, 999.0], np.float32)
    want = np.asarray(jax_unet.forward(SMOKE, params_np, jnp.asarray(x),
                                       jnp.asarray(t)))
    params = params_from_numpy(unet.schema(SMOKE), params_np, CPU)
    got = unet.forward(SMOKE, params, torch.from_numpy(x),
                       torch.from_numpy(t)).numpy()
    return got, want


def test_forward_matches_reference(smoke_params):
    got, want = forward_pair(smoke_params)
    assert got.shape == want.shape
    assert np.abs(want).max() > 0.1                  # conv_out redrawn
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("stride,size", [(2, 8), (2, 7), (1, 8)])
def test_conv2d_same_padding(stride, size):
    """The reference's "SAME": k=3, s=2 on an even input pads (0, 1)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, size, size, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)   # HWIO
    want = np.asarray(jax_unet.conv2d(jnp.asarray(x), jnp.asarray(w),
                                      stride=stride))
    got = unet.conv2d(torch.from_numpy(x),
                      torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      stride=stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B", [1, 3, 5, 8])
def test_forward_runs_its_products_at_the_bucket_width(B, monkeypatch):
    """Every matrix product of a forward on B images runs at
    shape_bucket(B) rows; the added rows leave the B images' results as
    they are (the card holds them bit for bit: tests/test_torch_cuda.py)."""
    import torch
    from repro_torch.core.execution import shape_bucket
    cfg = cfgs.SMOKE
    params = init_params(unet.schema(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    params["conv_out"] = torch.randn(
        params["conv_out"].shape, generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(B)
    x = torch.randn((B, cfg.image_size, cfg.image_size, cfg.in_channels),
                    generator=g)
    t = torch.randint(0, 1000, (B,), generator=g).float()
    rows = []
    mm = torch.Tensor.__matmul__

    def record(a, b):
        rows.append(a.shape[0])
        return mm(a, b)
    monkeypatch.setattr(torch.Tensor, "__matmul__", record)
    got = unet.forward(cfg, params, x, t)
    assert rows and set(rows) == {shape_bucket(B)}
    monkeypatch.setattr(unet, "product_rows", lambda n: n)
    torch.testing.assert_close(got, unet.forward(cfg, params, x, t),
                               rtol=1e-5, atol=1e-4)


def test_pad_rows():
    import torch
    x = torch.arange(6.0).reshape(3, 2)
    assert unet.pad_rows(x, 3) is x
    torch.testing.assert_close(unet.pad_rows(x, 4), torch.cat(
        [x, torch.zeros(1, 2)]))
    torch.testing.assert_close(unet.pad_rows(torch.ones(1), 2, -1.0),
                               torch.tensor([1.0, -1.0]))


def test_timestep_embedding_cos_then_sin():
    t = np.array([0.0, 1.0, 17.0, 500.0, 999.0], np.float32)
    want = np.asarray(jax_unet.timestep_embedding(jnp.asarray(t), 32))
    got = unet.timestep_embedding(torch.from_numpy(t), 32).numpy()
    np.testing.assert_array_equal(got[0], [1.0] * 16 + [0.0] * 16)  # t=0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_upsample_matches_nearest_resize():
    x = np.random.default_rng(3).standard_normal((2, 4, 4, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 8, 8, 3),
                                       "nearest"))
    got = unet.upsample2x(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", [cfgs.SMOKE, cfgs.CONFIG],
                         ids=lambda c: c.name)
def test_gn_silu_calls_counts_the_forward(cfg, monkeypatch):
    """``gn_silu_calls`` (read off the schema) equals the calls one
    forward makes: 45 at CONFIG."""
    calls = []
    real = unet.gn_silu
    monkeypatch.setattr(unet, "gn_silu",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    if cfg is cfgs.CONFIG:
        # count on a 1/16-width copy: the call graph depends on depth
        # and resolutions only, never on channel widths
        cfg = dataclasses.replace(cfg, base_channels=8, num_groups=4)
    params = init_params(unet.schema(cfg), torch.Generator().manual_seed(0),
                         CPU)
    x = torch.zeros((1, cfg.image_size, cfg.image_size, cfg.in_channels))
    unet.forward(cfg, params, x, torch.zeros(1))
    assert len(calls) == unet.gn_silu_calls(cfg)
    if cfg.name == "ddim-cifar10":
        assert len(calls) == 45


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_unet.py
    got, want = forward_pair(redrawn_params(SMOKE))
    print(f"SMOKE forward, B=3, port vs reference on the CPU: max abs err "
          f"{np.abs(got - want).max():.3g}, "
          f"max |eps| {np.abs(want).max():.3g}")
