"""Card-only checks of the port's CUDA kernels, against their plain
PyTorch versions on the same card, and of the models that call them
against the same models on the CPU.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  The file imports no jax, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's kernel-test ones: 2e-5 in float32, 2e-2
in bfloat16 (a kernel and its plain version round bf16 outputs from f32
values that differ in the last f32 bits).  The transformer, card
against CPU, is held at 1e-3 with a float32 cache: cuBLAS and the CPU
sum the 256- and 512-term products of each matmul in other orders, and
this narrow variant's k is large (wk's fan_in rule gives it scale 1 at
KV = 1), which sharpens the softmax; measured 1.8e-4 on the H100.  With
the default bfloat16 cache it is held at 2e-2 (a cached k or v may round
to the neighbouring bf16 value).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import RunConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.configs.ddim_cifar10 import SMOKE  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.diffusion.executor import BatchDenoisingExecutor  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.groupnorm_silu import ops  # noqa: E402
from repro_torch.kernels.groupnorm_silu.ref import groupnorm_silu_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

pytestmark = pytest.mark.cuda

SHAPES = [(2, 8, 8, 32, 8), (1, 16, 16, 24, 6), (3, 4, 4, 16, 16),
          (16, 4, 4, 256, 32), (8, 32, 32, 384, 32)]
DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _close(got, want, dtype):
    tol = DTYPES[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("B,H,W,C,G", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_groupnorm_silu_kernel_matches_plain(cuda, B, H, W, C, G, dtype):
    tdt, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(B * H + C)
    x = (torch.randn((B, H, W, C), generator=gen, device=cuda) * 2
         + 0.5).to(tdt)
    s = torch.randn(C, generator=gen, device=cuda)
    b = torch.randn(C, generator=gen, device=cuda)
    before = ops.launches
    got = ops.groupnorm_silu(x, s, b, G)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    assert got.dtype == tdt and got.shape == x.shape
    want = groupnorm_silu_ref(x, s, b, G)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_groupnorm_silu_wrapper_rejects_non_nhwc(cuda):
    x = torch.randn((2, 4, 4, 16), device=cuda).permute(0, 3, 1, 2)
    s = torch.ones(4, device=cuda)
    with pytest.raises(ValueError):
        ops.groupnorm_silu(x, s, torch.zeros(4, device=cuda), 4)


def test_unet_forward_on_card_matches_cpu(cuda):
    """SMOKE forward: the kernel on the card, the plain version on the
    CPU, same params (conv_out redrawn so eps is not ~0)."""
    params = init_params(unet.schema(SMOKE), torch.Generator().manual_seed(0),
                         "cpu")
    params["conv_out"] = torch.randn(
        params["conv_out"].shape, generator=torch.Generator().manual_seed(1)
    ) / SMOKE.base_channels ** 0.5
    x = torch.randn((3, 16, 16, 3), generator=torch.Generator().manual_seed(2))
    t = torch.tensor([0.0, 417.0, 999.0])
    want = unet.forward(SMOKE, params, x, t)
    ex = BatchDenoisingExecutor(SMOKE, params, device=cuda)  # params to card
    before = ops.launches
    got = ex.eps_fn(x.to(cuda), t.to(cuda)).cpu()
    assert ops.launches - before == unet.gn_silu_calls(SMOKE)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


# -- rmsnorm ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 96), (2, 5, 3, 128),
                                   (1, 256), (5, 100), (8, 1, 2048),
                                   (8, 128, 2048), (2, 10000)])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("scale_dtype", list(DTYPES))
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype, scale_dtype):
    x = _randn(shape, 1, cuda, DTYPES[dtype][0])
    s = _randn(shape[-1:], 2, cuda, DTYPES[scale_dtype][0])
    before = rms_ops.launches
    got = rms_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    _close(got, rmsnorm_ref(x, s), dtype)


def test_rmsnorm_wrapper_rejects_bad_inputs(cuda):
    x = torch.randn((4, 64), device=cuda)
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x.T, torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.ones(64))              # scale on the CPU


# -- flash attention -------------------------------------------------------

FA_SHAPES = [(1, 64, 64, 2, 2, 32), (2, 64, 64, 4, 2, 64),
             (1, 32, 128, 4, 1, 64), (1, 128, 128, 2, 2, 128),
             (2, 100, 100, 8, 1, 64), (1, 7, 7, 4, 4, 64),
             (8, 128, 128, 32, 4, 64)]          # full-width TinyLlama prefill


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", FA_SHAPES)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 16), (True, 48)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Skv, H, KV, D,
                                              causal, window, dtype):
    dt = DTYPES[dtype][0]
    q = _randn((B, Sq, H, D), 1, cuda, dt)
    k = _randn((B, Skv, KV, D), 2, cuda, dt)
    v = _randn((B, Skv, KV, D), 3, cuda, dt)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    _close(got, attention_ref(q, k, v, causal=causal, window=window), dtype)


# -- decode attention ------------------------------------------------------

DEC_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 8, 32), (3, 512, 4, 1, 128),
              (2, 100, 8, 1, 64), (4, 1000, 32, 1, 64),
              (8, 512, 32, 4, 64)]              # full-width TinyLlama decode


@pytest.mark.parametrize("B,S,H,KV,D", DEC_SHAPES)
@pytest.mark.parametrize("window", [0, 16, 64])
@pytest.mark.parametrize("q_dtype,c_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
def test_decode_attention_kernel_matches_plain(cuda, B, S, H, KV, D, window,
                                               q_dtype, c_dtype):
    q = _randn((B, 1, H, D), 1, cuda, DTYPES[q_dtype][0])
    kc = _randn((B, S, KV, D), 2, cuda, DTYPES[c_dtype][0])
    vc = _randn((B, S, KV, D), 3, cuda, DTYPES[c_dtype][0])
    cur = torch.tensor(np.random.default_rng(B * S).integers(1, S + 1, B),
                       dtype=torch.int32, device=cuda)
    before = dec_ops.launches
    got = dec_ops.decode_attention(q, kc, vc, cur, window=window)
    torch.cuda.synchronize()
    assert dec_ops.launches == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    want = decode_attention_ref(q, kc, vc, cur, window=window)
    _close(got, want, "bfloat16" if "bfloat16" in (q_dtype, c_dtype)
           else "float32")


def test_decode_attention_zero_length_row_gives_zero(cuda):
    """cur_len = 0 masks everything: the kernels (Pallas and CUDA) give
    0, as no cache block is needed."""
    q = _randn((2, 1, 4, 64), 1, cuda)
    kc = _randn((2, 64, 2, 64), 2, cuda)
    cur = torch.tensor([0, 64], dtype=torch.int32, device=cuda)
    got = dec_ops.decode_attention(q, kc, kc, cur)
    assert float(got[0].abs().max()) == 0.0
    want = decode_attention_ref(q, kc, kc, cur)
    torch.testing.assert_close(got[1], want[1], atol=2e-5, rtol=2e-5)


# -- the transformer: card against CPU --------------------------------------

GQA = dataclasses.replace(smoke_variant(get_config("tinyllama-1.1b")),
                          num_heads=8, num_kv_heads=1, head_dim=64)


@pytest.mark.parametrize("kv_dtype,tol", [("float32", 1e-3),
                                          ("bfloat16", 2e-2)])
def test_decode_step_on_card_matches_cpu(cuda, kv_dtype, tol):
    """Prefill and one decode step of the narrow GQA model (G=8, D=64):
    the kernels on the card, the plain versions on the CPU."""
    run = RunConfig(kv_cache_dtype=kv_dtype)
    params = api.init_model(GQA, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, GQA.vocab_size, (3, 16)), dtype=torch.int64)
    outs = {}
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        n = (fa_ops.launches, dec_ops.launches, rms_ops.launches)
        logits, cache = api.make_prefill_step(GQA, run, 32)(p, toks.to(dev))
        step, cache = api.make_decode_step(GQA, run)(
            p, toks[:, -1:].to(dev), cache)
        outs[str(dev)] = (logits.cpu(), step.cpu())
        if dev == cuda:
            L = GQA.num_layers
            assert (fa_ops.launches - n[0], dec_ops.launches - n[1],
                    rms_ops.launches - n[2]) == (L, L, 2 * (2 * L + 1))
    (lc, sc), (lg, sg) = outs["cpu"], outs[str(cuda)]
    torch.testing.assert_close(lg, lc, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(sg, sc, atol=tol, rtol=tol)


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
