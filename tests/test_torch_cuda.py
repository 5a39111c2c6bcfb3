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
to the neighbouring bf16 value).  The SSD scan is held at the
reference's own tolerance for it, 3e-5 (2e-2 in bfloat16), and the
narrow zamba2, card against CPU with a bfloat16 cache, at 2e-2.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.config import RunConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.configs.ddim_cifar10 import SMOKE  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.diffusion.executor import BatchDenoisingExecutor  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_block_ref, decode_attention_ref, lse_combine)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.groupnorm_silu import ops  # noqa: E402
from repro_torch.kernels.groupnorm_silu.ref import groupnorm_silu_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.models import api, zamba2  # noqa: E402
from repro_torch.models.params import P, init_params, map_schema  # noqa: E402

pytestmark = pytest.mark.cuda

# (H, W, C) of every gn_silu call of a full-width ddim-cifar10 forward
# (G = 32) and of SMOKE's (G = 8): the lists that
# tests/test_torch_groupnorm_silu.py holds to a forward.
UNET_GN = [(4, 4, 256), (4, 4, 512), (8, 8, 256), (8, 8, 512),
           (16, 16, 128), (16, 16, 256), (16, 16, 384), (16, 16, 512),
           (32, 32, 128), (32, 32, 256), (32, 32, 384)]
SMOKE_GN = [(8, 8, 32), (8, 8, 64), (8, 8, 96), (8, 8, 128), (16, 16, 32),
            (16, 16, 64), (16, 16, 96)]
SHAPES = [(2, 8, 8, 32, 8), (1, 16, 16, 24, 6), (3, 4, 4, 16, 16),
          (16, 4, 4, 256, 32), (8, 32, 32, 384, 32)] + [
    (B, H, W, C, 32) for (H, W, C) in UNET_GN for B in (1, 8, 16)
    if (B, H, W, C) not in ((16, 4, 4, 256), (8, 32, 32, 384))] + [
    (2, H, W, C, 8) for (H, W, C) in SMOKE_GN] + [
    (1, 9, 11, 64, 32),     # 99 pixels: a ragged last pass
    (2, 33, 33, 96, 32),    # 1089 pixels in 288 threads, groups of 3
    (1, 5, 5, 6, 3),        # rows of 24 bytes: scalar loads
    (1, 256, 256, 32, 32),  # too large to hold: chunks, x read three times
]                           # (tests/test_torch_groupnorm_silu.py checks
                            # that the plans of these four do so)
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


def test_groupnorm_silu_misaligned_view_takes_scalar_loads(cuda):
    B, H, W, C, G = 2, 8, 8, 64, 32
    buf = _randn(B * H * W * C + 1, 3, cuda) * 2 + 0.5
    x = buf[1:].view(B, H, W, C)            # 4 bytes past a 16-byte line
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert ops.plan(B, H * W, C, G, 4, aligned=False).vec == 1
    s, b = _randn(C, 4, cuda), _randn(C, 5, cuda)
    before = ops.launches
    got = ops.groupnorm_silu(x, s, b, G)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    _close(got, groupnorm_silu_ref(x, s, b, G), "float32")


def _gn_f64(x, s, b, G):
    B, H, W, C = x.shape
    xd = x.double().reshape(B, H * W, G, C // G)
    mu = xd.mean(dim=(1, 3), keepdim=True)
    var = ((xd - mu) ** 2).mean(dim=(1, 3), keepdim=True)
    h = ((xd - mu) / torch.sqrt(var + 1e-6)).reshape(B, H, W, C)
    return torch.nn.functional.silu(h * s.double() + b.double())


@pytest.mark.parametrize("B,H,W,C", [(1, 32, 32, 384), (8, 32, 32, 128)])
def test_groupnorm_silu_centred_variance_at_an_offset(cuda, B, H, W, C):
    """x = randn + 100: the kernel, whose sums are split over threads and
    lanes, stays within 2x the plain version's distance from float64."""
    x = _randn((B, H, W, C), 7, cuda) + 100
    s, b = _randn(C, 8, cuda), _randn(C, 9, cuda)
    before = ops.launches
    got = ops.groupnorm_silu(x, s, b, 32)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    want = _gn_f64(x, s, b, 32)
    err = float((got.double() - want).abs().max())
    plain = float((groupnorm_silu_ref(x, s, b, 32).double() - want)
                  .abs().max())
    assert err <= 2 * plain, (err, plain)


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

# every rmsnorm call shape of the two LLM paths (TinyLlama d 2048, Zamba2
# d 2560 and d_inner 5120; decode S = 1, prefill S = 128) at B in {1, 8,
# 16}, odd widths, and rows wider than a block holds (chunks, x read
# again; tests/test_torch_rmsnorm.py checks that their plans do so)
RMS_PATH = [(B, S, d) for d in (2048, 2560, 5120) for S in (1, 128)
            for B in (1, 8, 16)]


@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 96), (2, 5, 3, 128),
                                   (1, 256), (5, 100), (2, 10000),
                                   (2, 40000), (3, 16388)] + RMS_PATH)
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


@pytest.mark.parametrize("d", [2048, 2560, 5120])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["x", "scale"])
def test_rmsnorm_misaligned_view_takes_scalar_loads(cuda, d, dtype, which):
    tdt = DTYPES[dtype][0]
    x, s = _randn((8, 1, d), 3, cuda, tdt), _randn(d, 4, cuda, tdt)
    buf = _randn(x.numel() + s.numel() + 1, 5, cuda, tdt)
    if which == "x":                 # one element past a 16-byte line
        x = buf[1:x.numel() + 1].view(x.shape)
    else:
        s = buf[1:d + 1]
    assert (x.data_ptr() | s.data_ptr()) % 16 != 0
    assert rms_ops.plan(d, x.element_size(), aligned=False).vec == 1
    before = rms_ops.launches
    got = rms_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    _close(got, rmsnorm_ref(x, s), dtype)


def test_rmsnorm_launch_refuses_a_plan_that_misses_the_row(cuda):
    x, s = _randn((2, 2048), 6, cuda), _randn(2048, 7, cuda)
    y = torch.empty_like(x)
    fn = rms_ops._entry()
    stream = torch.cuda.current_stream().cuda_stream
    for threads, nv, vec, chunks in ((256, 1, 4, 1),     # half the row
                                     (256, 6, 4, 1),     # no such template
                                     (512, 1, 4, 1),     # nor 16-byte nv 1
                                     (1024, 4, 4, 1),    # over the bound
                                     (256, 2, 8, 1)):    # not f32's vector
        rc = fn(x.data_ptr(), s.data_ptr(), y.data_ptr(), 2, 2048, 1e-6, 0,
                0, threads, nv, vec, chunks, stream)
        assert rc != 0, (threads, nv, vec, chunks)
    assert fn(x.data_ptr(), s.data_ptr(), y.data_ptr(), 2, 2048, 1e-6, 0, 0,
              256, 2, 4, 1, stream) == 0
    _close(y, rmsnorm_ref(x, s), "float32")


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
             (8, 128, 128, 32, 4, 64),          # full-width TinyLlama prefill
             (1, 100, 100, 4, 4, 80),
             (8, 128, 128, 32, 32, 80),         # full-width zamba2 prefill
             (16, 32, 32, 32, 32, 80),          # zamba2 calibration, B = 16
             (2, 96, 320, 8, 2, 80),            # the K/V ring wraps several
             (1, 200, 456, 4, 4, 128)]          # times, Sq < Skv


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


def test_flash_attention_wrapper_rejects_misaligned_inputs(cuda):
    """The kernel copies 16-byte chunks: a contiguous view that starts
    4 bytes into its storage is refused, not read misaligned."""
    q = _randn((1, 16, 4, 64), 1, cuda)
    k = _randn((1, 16, 2, 64), 2, cuda)
    shifted = torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape)
    shifted.copy_(k)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = fa_ops.launches
    for args in ((q, shifted, k), (q, k, shifted)):
        with pytest.raises(ValueError):
            fa_ops.flash_attention(*args)
    qs = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    qs.copy_(q)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(qs, k, k)
    assert fa_ops.launches == before


# -- decode attention ------------------------------------------------------

DEC_SHAPES = [(2, 256, 4, 2, 64), (1, 128, 8, 8, 32), (3, 512, 4, 1, 128),
              (2, 100, 8, 1, 64), (4, 1000, 32, 1, 64),
              (8, 512, 32, 4, 64),              # full-width TinyLlama decode
              (2, 100, 4, 4, 80),
              (8, 512, 32, 32, 80),             # full-width zamba2 decode
              (1, 4096, 32, 4, 64),             # B = 1: 64 splits
              (1, 4096, 32, 32, 80),
              (2, 200, 16, 1, 64),              # G = 16: two head slices
              (2, 300, 24, 1, 80),              # G = 24: slices of 6
              (2, 300, 32, 1, 128),             # G = 32, D = 128: the
              (3, 700, 64, 2, 128)]             # register edge


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


def _dec_inputs(B, S, H, KV, D, device, q_dtype="float32",
                c_dtype="bfloat16"):
    return (_randn((B, 1, H, D), 1, device, DTYPES[q_dtype][0]),
            _randn((B, S, KV, D), 2, device, DTYPES[c_dtype][0]),
            _randn((B, S, KV, D), 3, device, DTYPES[c_dtype][0]))


def _dec_check(q, kc, vc, cur, window=0):
    cur = torch.tensor(cur, dtype=torch.int32, device=q.device)
    before = dec_ops.launches
    got = dec_ops.decode_attention(q, kc, vc, cur, window=window)
    torch.cuda.synchronize()
    assert dec_ops.launches == before + 1
    want = decode_attention_ref(q, kc, vc, cur, window=window)
    tol = 2e-5 if q.dtype == kc.dtype == torch.float32 else 2e-2
    for b, n in enumerate(cur.tolist()):
        if n == 0:          # every position masked: the kernel gives 0
            assert float(got[b].abs().max()) == 0.0
        else:
            torch.testing.assert_close(got[b].float(), want[b].float(),
                                       atol=tol, rtol=tol)
    return got


@pytest.mark.parametrize("B,S,KV", [(8, 2048, 8), (2, 1024, 2)])
@pytest.mark.parametrize("c_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 3, 6, 12])
def test_decode_attention_cur_len_on_and_past_a_split_boundary(
        cuda, B, S, KV, c_dtype, k):
    """Each split takes whole 64-row tiles of the valid range, so a row
    ends on a split boundary at cur_len = 64 k and one past it at
    64 k + 1 (a last tile with one valid row).  (8, 2048, 8) gives 5
    splits of several tiles each, (2, 1024, 2) 16 splits of one."""
    q, kc, vc = _dec_inputs(B, S, 4 * KV, KV, 64, cuda, "float32", c_dtype)
    cur = [64 * k + (b % 2) for b in range(B)]
    _dec_check(q, kc, vc, cur)


@pytest.mark.parametrize("B,S,H,KV,D", [(2, 4096, 32, 4, 64),
                                         (1, 2048, 32, 32, 80),
                                         (2, 1024, 48, 1, 128)])
@pytest.mark.parametrize("window", [0, 700])
@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_decode_attention_block_matches_plain(cuda, B, S, H, KV, D, window,
                                              n, q_dtype):
    """The block variant on each of n blocks of a bf16 cache (some empty,
    windows across block boundaries): o (float32) and lse against the
    plain version, the same blocks empty (lse -inf, o 0), and the blocks
    combined against the whole-cache kernel, float32 at 2e-5 (q in bf16:
    2e-2); one launch a block, counted apart."""
    q, kc, vc = _dec_inputs(B, S, H, KV, D, cuda, q_dtype, "bfloat16")
    cur = torch.tensor([S - 3, S // 3 + 1][:B], dtype=torch.int32,
                       device=cuda)
    R, outs, lses = S // n, [], []
    before, blocks = dec_ops.launches, dec_ops.launches_block
    for i in range(n):
        kb, vb = (t[:, i * R:(i + 1) * R].contiguous() for t in (kc, vc))
        o, lse = dec_ops.decode_attention_block(q, kb, vb, cur,
                                                window=window, offset=i * R)
        ro, rl = decode_attention_block_ref(q, kb, vb, cur, window=window,
                                            offset=i * R)
        assert o.dtype == lse.dtype == torch.float32
        tol = "bfloat16" if q_dtype == "bfloat16" else "float32"
        _close(o, ro, tol)
        empty = torch.isinf(rl)
        assert torch.equal(torch.isinf(lse), empty)
        assert not torch.isnan(o).any() and (o[empty.any(-1)] == 0).all()
        if not bool(empty.all()):
            _close(lse[~empty], rl[~empty], tol)
        outs.append(o)
        lses.append(lse)
    torch.cuda.synchronize()
    assert dec_ops.launches_block == blocks + n
    whole = dec_ops.decode_attention(q.float(), kc, vc, cur, window=window)
    assert dec_ops.launches == before + 1
    _close(lse_combine(torch.stack(outs), torch.stack(lses)), whole,
           "bfloat16" if q_dtype == "bfloat16" else "float32")


def test_decode_attention_block_with_a_first_position(cuda):
    """``lo`` raises each row's first valid position (the slice-reads
    window over a sequence-split cache): the kernel against the plain
    version at an offset."""
    q, kc, vc = _dec_inputs(3, 2048, 32, 4, 64, cuda)
    cur = torch.tensor([3000, 2100, 1500], dtype=torch.int32, device=cuda)
    lo = torch.tensor([2900, 1000, 1400], dtype=torch.int32, device=cuda)
    got = dec_ops.decode_attention_block(q, kc, vc, cur, window=512,
                                         offset=1024, lo=lo)
    want = decode_attention_block_ref(q, kc, vc, cur, window=512,
                                      offset=1024, lo=lo)
    _close(got[0], want[0], "float32")
    _close(got[1], want[1], "float32")


def test_decode_attention_zero_rows_beside_full_rows(cuda):
    """Rows with cur_len = 0 between full rows at a many-split shape:
    the zero rows give exactly 0, the others match."""
    q, kc, vc = _dec_inputs(4, 1024, 32, 4, 64, cuda)
    _dec_check(q, kc, vc, [1024, 0, 1, 0])


@pytest.mark.parametrize("B,S,H,KV,D", [(1, 4096, 32, 4, 64),
                                        (8, 2048, 32, 8, 80)])
@pytest.mark.parametrize("window", [100, 700, 1000])
def test_decode_attention_window_starting_past_the_first_tiles(
        cuda, B, S, H, KV, D, window):
    """A window whose start lies many tiles into the cache and inside a
    tile: the tiles before it are skipped, the first one processed is
    partly masked."""
    q, kc, vc = _dec_inputs(B, S, H, KV, D, cuda)
    cur = [S - 37 * b for b in range(B)]
    _dec_check(q, kc, vc, cur, window=window)


@pytest.mark.parametrize("S", [100, 1000, 4001])
@pytest.mark.parametrize("q_dtype,c_dtype", [("float32", "float32"),
                                             ("float32", "bfloat16")])
def test_decode_attention_full_rows_with_a_ragged_last_tile(cuda, S, q_dtype,
                                                            c_dtype):
    """Every row at cur_len = S with S not a multiple of 64: the last
    tile's rows past S are never read."""
    q, kc, vc = _dec_inputs(2, S, 32, 4, 64, cuda, q_dtype, c_dtype)
    _dec_check(q, kc, vc, [S, S])


@pytest.mark.parametrize("which", ["q", "k_cache", "v_cache"])
def test_decode_attention_refuses_a_misaligned_view(cuda, which):
    """The kernel loads 16-byte chunks: a view one element past a
    16-byte boundary is refused, never run by another path."""
    args = dict(zip(("q", "k_cache", "v_cache"),
                    _dec_inputs(2, 128, 8, 2, 64, cuda, "float32",
                                "float32")))
    t = args[which]
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    args[which] = buf[1:].view(t.shape).copy_(t)
    assert args[which].is_contiguous() and args[which].data_ptr() % 16
    cur = torch.tensor([128, 64], dtype=torch.int32, device=cuda)
    before = dec_ops.launches
    with pytest.raises(ValueError, match="16-byte"):
        dec_ops.decode_attention(args["q"], args["k_cache"], args["v_cache"],
                                 cur)
    assert dec_ops.launches == before


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_decode_attention_writes_every_column_at_head_dim_80(cuda, q_dtype):
    """At D = 80 a lane holds columns lane, lane+32 and (lanes 0-15)
    lane+64.  The output's memory is filled with NaN before the call (the
    caching allocator hands the freed block back), so a column left
    unwritten shows."""
    dt = DTYPES[q_dtype][0]
    q = _randn((4, 1, 8, 80), 1, cuda, dt)
    kc = _randn((4, 64, 8, 80), 2, cuda, dt)
    vc = _randn((4, 64, 8, 80), 3, cuda, dt)
    cur = torch.tensor([1, 17, 64, 40], dtype=torch.int32, device=cuda)
    torch.full_like(q, float("nan"))       # freed at once, then reused
    got = dec_ops.decode_attention(q, kc, vc, cur)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.float()).all())
    assert float(got[..., 64:].float().abs().max()) > 0
    _close(got, decode_attention_ref(q, kc, vc, cur), q_dtype)


# -- decode attention on the tensor cores ------------------------------------

TYPE_PAIRS = [("float32", "float32"), ("bfloat16", "bfloat16"),
              ("float32", "bfloat16")]


def _tc_check(q, kc, vc, cur, path, window=0):
    """One decode_attention call against the plain version, the plan's
    path asserted; tolerance by the types involved."""
    B, S, KV, D = kc.shape
    p = dec_ops.plan(B, S, q.shape[2], KV, D, q.dtype, kc.dtype)
    assert p.path == path
    got = _dec_check(q, kc, vc, cur, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape


@pytest.mark.parametrize("B,S,H,KV,D,full", [
    (8, 512, 48, 1, 128, False),          # granite-34b, random cur_len
    (8, 512, 48, 1, 128, True),
    (8, 1601, 64, 8, 128, True),          # the VLM's cross decode
    (8, 1601, 64, 8, 128, False)])
@pytest.mark.parametrize("q_dtype,c_dtype", TYPE_PAIRS)
def test_decode_attention_tensor_path_at_the_path_shapes(
        cuda, B, S, H, KV, D, full, q_dtype, c_dtype):
    """granite's G = 48 over one KV head and the VLM's whole 1601-row
    cross caches take the tensor-core kernel and match the plain
    version: 2e-5 in float32, 2e-2 where bfloat16 is involved."""
    q, kc, vc = _dec_inputs(B, S, H, KV, D, cuda, q_dtype, c_dtype)
    cur = [S] * B if full else \
        np.random.default_rng(21).integers(1, S + 1, B).tolist()
    _tc_check(q, kc, vc, cur, "tensor")


@pytest.mark.parametrize("G", [3, 8, 16, 48, 64, 96])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("q_dtype,c_dtype", TYPE_PAIRS)
def test_decode_attention_groups_on_both_sides_of_the_path_rule(
        cuda, G, D, window, q_dtype, c_dtype):
    """G < 8, and 8 over rows of 64, take the CUDA-core kernel; 8 over
    rows of 128 and every G > 8 (64 and 96 in 4 and 6 blocks of 16
    heads) the tensor-core kernel; both match the plain version."""
    KV = 2
    q, kc, vc = _dec_inputs(3, 300, G * KV, KV, D, cuda, q_dtype, c_dtype)
    path = "tensor" if G > 8 or G * D >= 1024 else "cuda-core"
    assert dec_ops.tensor_path(G, D) == (path == "tensor")
    _tc_check(q, kc, vc, [300, 171, 9], path, window=window)


@pytest.mark.parametrize("H,KV,D", [(48, 1, 128), (64, 8, 128),
                                    (16, 1, 64), (24, 1, 80),
                                    (96, 2, 32)])
@pytest.mark.parametrize("q_dtype,c_dtype", TYPE_PAIRS)
def test_decode_attention_tensor_path_inside_a_granule(cuda, H, KV, D,
                                                       q_dtype, c_dtype):
    """cur_len ending inside a 16-row granule (16 k + 1, + 7, + 15) and
    windows starting inside one (23, 41 rows), beside rows of one
    position, one granule and a whole cache."""
    q, kc, vc = _dec_inputs(8, 640, H, KV, D, cuda, q_dtype, c_dtype)
    cur = [1, 16, 17, 23, 111, 319, 640, 401]
    for window in (0, 23, 41):
        _tc_check(q, kc, vc, cur, "tensor", window=window)


@pytest.mark.parametrize("H,KV,D", [(48, 1, 128), (64, 8, 128),
                                    (32, 2, 64)])
@pytest.mark.parametrize("q_dtype,c_dtype", TYPE_PAIRS)
def test_decode_attention_block_on_the_tensor_path(cuda, H, KV, D, q_dtype,
                                                   c_dtype):
    """The block variant on the tensor-core kernel: blocks of a cache
    at an offset with a window and a first position (lo) per row, some
    empty; o and lse against the plain version, empty rows o = 0 and
    lse = -inf, and the blocks joined by log-sum-exp against the
    whole-cache kernel."""
    B, S, n = 4, 1024, 4
    q, kc, vc = _dec_inputs(B, S, H, KV, D, cuda, q_dtype, c_dtype)
    assert dec_ops.plan(B, S // n, H, KV, D, q.dtype,
                        kc.dtype).path == "tensor"
    cur = torch.tensor([1024, 700, 257, 33], dtype=torch.int32, device=cuda)
    lo = torch.tensor([500, 0, 240, 30], dtype=torch.int32, device=cuda)
    tol = "float32" if q_dtype == c_dtype == "float32" else "bfloat16"
    R, outs, lses = S // n, [], []
    blocks = dec_ops.launches_block
    for i in range(n):
        kb, vb = (t[:, i * R:(i + 1) * R].contiguous() for t in (kc, vc))
        o, lse = dec_ops.decode_attention_block(q, kb, vb, cur, window=600,
                                                offset=i * R, lo=lo)
        ro, rl = decode_attention_block_ref(q, kb, vb, cur, window=600,
                                            offset=i * R, lo=lo)
        _close(o, ro, tol)
        empty = torch.isinf(rl)
        assert torch.equal(torch.isinf(lse), empty)
        assert not torch.isnan(o).any() and (o[empty.any(-1)] == 0).all()
        if not bool(empty.all()):
            _close(lse[~empty], rl[~empty], tol)
        outs.append(o)
        lses.append(lse)
    torch.cuda.synchronize()
    assert dec_ops.launches_block == blocks + n
    whole, _ = decode_attention_block_ref(q, kc, vc, cur, window=600, lo=lo)
    _close(lse_combine(torch.stack(outs), torch.stack(lses)), whole, tol)


@pytest.mark.parametrize("B,S,H,KV,D", [(8, 512, 48, 1, 128),
                                        (8, 1601, 64, 8, 128),
                                        (8, 512, 32, 4, 128),
                                        (8, 200, 96, 1, 32),
                                        (8, 300, 24, 1, 80)])
@pytest.mark.parametrize("q_dtype,c_dtype", TYPE_PAIRS)
def test_decode_attention_plan_holds_on_the_card(cuda, B, S, H, KV, D,
                                                 q_dtype, c_dtype):
    """The plan's shared memory is the kernel's, and its blocks an SM
    (its split count's basis) what the card reports for the tensor-core
    kernel (cudaOccupancyMaxActiveBlocksPerMultiprocessor) where shared
    memory binds (every D = 128 shape here), a lower bound where the
    registers allow more than the ``TC_MIN_BLOCKS`` that
    __launch_bounds__ guarantees; so the grid is at most one wave on
    this card's SMs."""
    qd, cd = DTYPES[q_dtype][0], DTYPES[c_dtype][0]
    p = dec_ops.plan(B, S, H, KV, D, qd, cd)
    assert p.path == "tensor"
    smem, blocks = dec_ops.tc_occupancy(D, qd, cd, p.heads)
    assert smem == p.smem and blocks >= p.resident
    if p.resident < dec_ops.TC_MIN_BLOCKS:
        assert blocks == p.resident
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert sms == dec_ops.SMS
    assert p.splits == 1 or math.prod(p.grid) <= sms * blocks


# -- ssd scan ----------------------------------------------------------------

SSD_SHAPES = [(2, 64, 3, 16, 8, 16), (1, 128, 2, 32, 16, 32),
              (2, 32, 1, 8, 8, 32), (1, 48, 3, 24, 12, 16),
              (2, 256, 4, 64, 64, 128), (1, 40, 5, 64, 64, 40),
              (16, 32, 80, 64, 64, 128),        # zamba2 calibration prefill
              (8, 128, 80, 64, 64, 128),        # full-width zamba2 prefill
              # chunks past the kernel's 128-row score tile
              (1, 288, 2, 64, 64, 144), (2, 160, 3, 16, 8, 160)]
SSD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _ssd_inputs(B, S, H, P, N, device, dtype, decay=0.2, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=device)
    return (rn(B, S, H, P).to(dtype), (-rn(B, S, H).abs() * decay).to(dtype),
            (rn(B, S, N) * 0.3).to(dtype), (rn(B, S, N) * 0.3).to(dtype),
            rn(B, H, P, N) * 0.1)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk, dtype):
    args = _ssd_inputs(B, S, H, P, N, cuda, DTYPES[dtype][0])
    before = ssd_ops.launches
    y, h = ssd_ops.ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    assert y.dtype == args[0].dtype and h.dtype == torch.float32
    wy, wh = ssd_scan_ref(*args, chunk=chunk)
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, wh, atol=tol, rtol=tol)


def _ssd_f64(x, a, b, c, h0):
    """The recurrence step by step in float64: the exact answer."""
    x, a, b, c, h = (t.double() for t in (x, a, b, c, h0))
    ys = []
    for t in range(x.shape[1]):
        h = h * torch.exp(a[:, t])[..., None, None] \
            + x[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], h))
    return torch.stack(ys, dim=1), h


def test_ssd_scan_kernel_with_strong_decay_stays_finite(cuda):
    """-cum passes 200 inside a chunk of 128 (e^{-cum} would be inf in
    float32); the kernel takes e^{cum_q - cum_k} and stays finite.  At
    such |cum| an ulp of a float32 cum moves a decay by ~3e-5 relative
    (the plain version's cum is float32, the kernel's float64), so both
    are held to the float64 recurrence: the kernel within twice the
    plain version's error."""
    args = _ssd_inputs(2, 128, 4, 64, 64, cuda, torch.float32, decay=3.0)
    assert float(args[1].sum(dim=1).min()) < -200
    got, plain = ssd_ops.ssd_scan(*args), ssd_scan_ref(*args)
    exact = _ssd_f64(*args)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    for g, p, e in zip(got, plain, exact):
        err_plain = float((p.double() - e).abs().max())
        assert float((g.double() - e).abs().max()) <= max(2 * err_plain,
                                                          3e-5)


@pytest.mark.parametrize("seed", range(4))
def test_ssd_scan_kernel_at_the_path_decays(cuda, seed):
    """The full-width Zamba2 prefill shape at the path's decays, a = dt
    * A = -softplus(N(0,1)) at A = -1: -cum reaches ~100 in the chunk of
    128.  Held to the float64 recurrence as chip_smoke.py holds it: the
    kernel within twice the plain version's error (or 3e-5)."""
    x, _, b, c, h0 = _ssd_inputs(8, 128, 80, 64, 64, cuda, torch.float32,
                                 seed=seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 100)
    a = -torch.nn.functional.softplus(
        torch.randn((8, 128, 80), generator=g, device=cuda))
    args = (x, a, b, c, h0)
    exact = _ssd_f64(*args)
    for g, p, e in zip(ssd_ops.ssd_scan(*args), ssd_scan_ref(*args), exact):
        err_plain = float((p.double() - e).abs().max())
        assert float((g.double() - e).abs().max()) <= max(2 * err_plain,
                                                          3e-5)


def test_ssd_scan_mixed_input_types(cuda):
    """The bf16-params path: x and a float32, B/C bfloat16."""
    x, a, b, c, h0 = _ssd_inputs(2, 64, 3, 64, 64, cuda, torch.float32)
    b, c = b.bfloat16(), c.bfloat16()
    y, h = ssd_ops.ssd_scan(x, a, b, c, h0, chunk=32)
    wy, wh = ssd_scan_ref(x, a, b, c, h0, chunk=32)
    torch.testing.assert_close(y, wy, atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(h, wh, atol=3e-5, rtol=3e-5)


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


# -- zamba2: card against CPU -------------------------------------------------

D80 = dataclasses.replace(smoke_variant(get_config("zamba2-2.7b")),
                          d_model=320, num_layers=4)


def test_zamba2_on_card_matches_cpu(cuda):
    """Prefill and one decode step of the narrow zamba2 (D = 80, two
    groups, bfloat16 cache): the kernels on the card, the plain versions
    on the CPU; launches per prefill 4 ssd_scan and 2 flash, per decode
    step 2 decode, per forward 2*4 + 2*2 + 1 = 13 rmsnorm.  Weights are
    drawn with std 0.05: at the reference's init q and k have std ~9 and
    each softmax is one-hot, so rounding would pick the winning key."""
    run = RunConfig()
    sch = map_schema(lambda p, _: p if p.init in ("ones", "zeros")
                     else P(p.shape, p.axes, scale=0.05), zamba2.schema(D80))
    params = init_params(sch, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, D80.vocab_size, (3, 32)), dtype=torch.int64)
    outs = {}
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        n = (ssd_ops.launches, fa_ops.launches, dec_ops.launches,
             rms_ops.launches)
        logits, cache = api.make_prefill_step(D80, run, 64)(p, toks.to(dev))
        step, cache = api.make_decode_step(D80, run)(
            p, toks[:, -1:].to(dev), cache)
        outs[str(dev)] = (logits.cpu(), step.cpu(), cache["ssm"]["ssm"].cpu())
        if dev == cuda:
            assert (ssd_ops.launches - n[0], fa_ops.launches - n[1],
                    dec_ops.launches - n[2], rms_ops.launches - n[3]) \
                == (4, 2, 2, 26)
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


# -- the bucketed pool engine on CUDA graphs ----------------------------------

def _smoke_executor(cuda, redraw=True):
    """SMOKE on the card; conv_out redrawn (``redraw``) so eps is not ~0,
    or at the reference's init (1e-10), as the reference's tests run."""
    params = init_params(unet.schema(SMOKE), torch.Generator().manual_seed(0),
                         "cpu")
    if redraw:
        params["conv_out"] = torch.randn(
            params["conv_out"].shape,
            generator=torch.Generator().manual_seed(1)
        ) / SMOKE.base_channels ** 0.5
    return BatchDenoisingExecutor(SMOKE, params, device=cuda)


def _plan(counts, batches):
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.plan import BatchPlan
    idx = {k: 0 for k in counts}
    bb = []
    for ks in batches:
        bb.append([(k, idx[k]) for k in ks])
        for k in ks:
            idx[k] += 1
    return BatchPlan(batches=bb, start_times=[0.0] * len(bb),
                     steps_completed=dict(counts), delay=DelayModel())


# sizes 5, 4, 4, 3, 2, 2, 1, ...: buckets 8, 4, 2; stable phases fuse
BUCKET_COUNTS = {0: 9, 1: 6, 2: 4, 3: 2, 4: 1}
# sizes 8, 8, 8, 4, 4, 2, 2: every batch already fills its bucket
POW2_COUNTS = {0: 7, 1: 7, 2: 5, 3: 5, 4: 3, 5: 3, 6: 3, 7: 3}


def _stacked(counts):
    rem, out = dict(counts), []
    while any(rem.values()):
        ks = sorted(k for k, v in rem.items() if v)
        out.append(ks)
        for k in ks:
            rem[k] -= 1
    return out


def _latents(counts, seed=3):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((16, 16, 3)).astype(np.float32)
            for k in counts}


@pytest.mark.parametrize("timed", [False, True])
def test_bucketed_graphs_match_eager_on_card(cuda, timed):
    """Graph replays (steps, and multi-step chunks when untimed) against
    the same pool functions run eagerly on the card, at the same padded
    shapes: within MATCH_TOL."""
    from repro_torch.core.execution import shape_bucket
    from repro_torch.diffusion.bucketed import MATCH_TOL, pool_step
    ex = _smoke_executor(cuda)
    plan = _plan(BUCKET_COUNTS, _stacked(BUCKET_COUNTS))
    lat = _latents(BUCKET_COUNTS)
    got, _ = ex.run(plan, latents=lat, timed=timed, exec_engine="bucketed")
    assert ex._programs and all(k[0] in ("bstep", "bscan")
                                for k in ex._programs)
    # the eager pool path, one step a batch, by hand
    sess = ex.open_session(plan, latents=lat, exec_engine="dict")
    ids = sorted(lat)
    pool = torch.stack([torch.from_numpy(lat[k]) for k in ids]
                       + [torch.zeros(16, 16, 3)]).to(cuda)
    for ks in _stacked(BUCKET_COUNTS):
        Bp = shape_bucket(len(ks))
        lanes = np.full((3, Bp), -1, np.int64)
        lanes[0] = len(ids)
        for i, k in enumerate(ks):
            rem = sess._remaining[k]
            lanes[:, i] = ids.index(k), rem[0], rem[1] if len(rem) > 1 \
                else -1
            rem.pop(0)
        t = torch.from_numpy(lanes).to(cuda)
        pool_step(ex.step_fn, pool, t[0], t[1], t[2])
    eager = pool.cpu().numpy()
    for k in ids:
        np.testing.assert_allclose(got[k], eager[ids.index(k)], **MATCH_TOL)
        assert np.abs(got[k] - lat[k]).max() > 1e-2


@pytest.mark.parametrize("redraw,counts", [(False, BUCKET_COUNTS),
                                           (True, BUCKET_COUNTS),
                                           (True, POW2_COUNTS)])
def test_bucketed_graphs_match_dict_on_card(cuda, redraw, counts):
    """The bucketed engine's graphs against the dict engine on the card,
    within MATCH_TOL: at the reference's init and with eps of order 1
    (conv_out redrawn), on batches that need padding and on batches that
    fill their bucket."""
    from repro_torch.diffusion.bucketed import MATCH_TOL
    ex = _smoke_executor(cuda, redraw)
    plan = _plan(counts, _stacked(counts))
    lat = _latents(counts)
    for timed in (False, True):
        got, _ = ex.run(plan, latents=lat, timed=timed,
                        exec_engine="bucketed")
        want, _ = ex.run(plan, latents=lat, exec_engine="dict")
        for k, T in counts.items():
            np.testing.assert_allclose(got[k], want[k], **MATCH_TOL)
            if T > 1:                       # one step is t = 0: ~no move
                assert np.abs(got[k] - lat[k]).max() > 1e-2


@pytest.mark.parametrize("B", [B for B in range(1, 16) if B & (B - 1)])
def test_unet_rows_are_the_same_at_the_bucket_width(cuda, B):
    """A forward on B images gives each the same result, bit for bit, as
    the forward on them padded to shape_bucket(B), the bucketed engine's
    width (its matrix products run at the bucket in both)."""
    from repro_torch.core.execution import shape_bucket
    params = _smoke_executor(cuda).params
    g = torch.Generator().manual_seed(B)
    Bp = shape_bucket(B)
    x = torch.zeros((Bp, 16, 16, 3))
    x[:B] = torch.randn((B, 16, 16, 3), generator=g)
    t = torch.full((Bp,), -1.0)
    t[:B] = torch.randint(0, 1000, (B,), generator=g).float()
    x, t = x.to(cuda), t.to(cuda)
    want = unet.forward(SMOKE, params, x, t)[:B]
    got = unet.forward(SMOKE, params, x[:B], t[:B])
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_bucketed_launch_accounting_is_exact(cuda):
    """Each graph captured gn_silu_calls launches per step it holds.  The
    wrapper's counter moves at eager calls and at capture, not at a
    replay: it reads gn_silu_calls per eager forward plus the launches
    captured, and the graphs' replays run the plan's steps."""
    ex = _smoke_executor(cuda)
    calls = unet.gn_silu_calls(SMOKE)
    plan = _plan(BUCKET_COUNTS, _stacked(BUCKET_COUNTS))
    ops.launches, f0 = 0, ex.forwards
    ex.run(plan, latents=_latents(BUCKET_COUNTS), exec_engine="bucketed")
    torch.cuda.synchronize()
    counts = ex.graph_counts()
    assert any(k[0] == "bscan" for k in counts)
    for key, c in counts.items():
        assert c["launches"] == calls * c["steps"], key
        assert c["replays"] >= 1
    eager = ex.forwards - f0                     # the warm steps
    assert eager == len({(k[1], k[2]) for k in counts})
    assert ops.launches == calls * eager + sum(
        c["launches"] for c in counts.values())
    assert sum(c["steps"] * c["replays"] for c in counts.values()) == \
        plan.num_batches


def test_second_session_captures_nothing(cuda):
    ex = _smoke_executor(cuda)
    plan = _plan(BUCKET_COUNTS, _stacked(BUCKET_COUNTS))
    ex.run(plan, latents=_latents(BUCKET_COUNTS), exec_engine="bucketed")
    n, before = len(ex.compile_log), ops.launches
    sess = ex.open_session(plan, latents=_latents(BUCKET_COUNTS, 4),
                           exec_engine="bucketed")
    sess.run_plan(_stacked(BUCKET_COUNTS))
    tele = sess.telemetry()
    assert tele["compiles"] == 0 and tele["compile_s"] == 0.0
    assert tele["dispatches"] > 0
    assert len(ex.compile_log) == n and ops.launches == before


def test_interleaved_sessions_keep_their_own_rows(cuda):
    """Two sessions of one pool size on one executor, stepped in turns,
    each end with the images it gives when run alone."""
    from repro_torch.diffusion.bucketed import MATCH_TOL
    ex = _smoke_executor(cuda)
    counts = {0: 4, 1: 3, 2: 2}
    batches = _stacked(counts)
    plan = _plan(counts, batches)
    lats = [_latents(counts, 5), _latents(counts, 6)]
    alone = [ex.run(plan, latents=lat, exec_engine="bucketed")[0]
             for lat in lats]
    sessions = [ex.open_session(plan, latents=lat, exec_engine="bucketed")
                for lat in lats]
    for ks in batches:
        for sess in sessions:
            sess.run_batch(ks, timed=True)
    for sess, want in zip(sessions, alone):
        got = sess.finish()
        for k in counts:
            np.testing.assert_allclose(got[k], want[k], **MATCH_TOL)
    assert not np.allclose(alone[0][0], alone[1][0])


def test_failing_capture_raises_and_caches_nothing(cuda):
    """A step that syncs the host cannot be captured: the run raises; no
    eager fallback runs and no program is cached."""
    ex = _smoke_executor(cuda)
    counts = {0: 2, 1: 2}
    plan = _plan(counts, _stacked(counts))
    step = ex.step_fn

    def syncing(x, t_now, t_next):
        float(t_now.sum())                        # a host read
        return step(x, t_now, t_next)
    ex.step_fn = syncing
    sess = ex.open_session(plan, latents=_latents(counts),
                           exec_engine="bucketed")
    with pytest.raises(RuntimeError):
        sess.run_batch([0, 1])
    assert ex._programs == {} and ex.compile_log == []
    assert sess.steps_done == {0: 0, 1: 0}
    torch.cuda.synchronize()


# -- training: gradients through the kernels ---------------------------------

def _grads(fn, inputs, dout):
    """fn(*leaves) and the leaves' grads at ``dout`` (a tensor or a
    tuple matching fn's outputs), on fresh leaf copies of ``inputs``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    outs = out if isinstance(out, tuple) else (out,)
    douts = dout if isinstance(dout, tuple) else (dout,)
    torch.autograd.backward(outs, douts)
    return out, [t.grad for t in leaves]


@pytest.mark.parametrize("shape", [(2, 128, 2048), (8, 512, 2048),
                                   (3, 16, 64), (2, 64, 2560)])
def test_rmsnorm_function_grads_equal_plain_autograd(cuda, shape):
    """Under grad the wrapper launches the kernel once through its
    Function: forward within 2e-5 of the plain version, grads of x and
    scale ``==`` autograd through the plain version (its backward)."""
    x, s = _randn(shape, 1, cuda), _randn(shape[-1:], 2, cuda) + 1
    dy = _randn(shape, 3, cuda)
    before = rms_ops.launches
    y, (dx, ds) = _grads(rms_ops.rmsnorm, (x, s), dy)
    assert rms_ops.launches == before + 1 and y.grad_fn is not None
    y_ref, (dx_ref, ds_ref) = _grads(rmsnorm_ref, (x, s), dy)
    _close(y, y_ref, "float32")
    assert torch.equal(dx, dx_ref) and torch.equal(ds, ds_ref)


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 128, 32, 4, 64, 0), (8, 512, 32, 4, 64, 0), (2, 128, 32, 4, 64, 48),
    (2, 64, 32, 32, 80, 0)])
def test_flash_attention_function_grads_equal_plain_autograd(cuda, B, S, H,
                                                             KV, D, window):
    q = _randn((B, S, H, D), 1, cuda)
    k, v = _randn((B, S, KV, D), 2, cuda), _randn((B, S, KV, D), 3, cuda)
    do = _randn((B, S, H, D), 4, cuda)
    before = fa_ops.launches
    o, grads = _grads(lambda *t: fa_ops.flash_attention(*t, window=window),
                      (q, k, v), do)
    assert fa_ops.launches == before + 1 and o.grad_fn is not None
    o_ref, want = _grads(lambda *t: attention_ref(*t, window=window),
                         (q, k, v), do)
    _close(o, o_ref, "float32")
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 128, 4, 64, 16, 128),
                                             (1, 256, 2, 64, 64, 128)])
def test_ssd_scan_function_grads_equal_plain_autograd(cuda, B, S, H, P, N,
                                                      chunk):
    ins = _ssd_inputs(B, S, H, P, N, cuda, torch.float32)
    dy, dh = _randn((B, S, H, P), 7, cuda), _randn((B, H, P, N), 8, cuda)
    before = ssd_ops.launches
    (y, h), grads = _grads(lambda *t: ssd_ops.ssd_scan(*t, chunk=chunk),
                           ins, (dy, dh))
    assert ssd_ops.launches == before + 1 and y.grad_fn is not None
    (y_ref, h_ref), want = _grads(
        lambda *t: ssd_scan_ref(*t, chunk=chunk), ins, (dy, dh))
    torch.testing.assert_close(y, y_ref, atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(h, h_ref, atol=3e-5, rtol=3e-5)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def test_gradless_kernels_raise_under_grad(cuda):
    """decode_attention and groupnorm_silu have no backward: a CUDA input
    that needs a gradient raises under grad mode, and launches as before
    under ``torch.no_grad``."""
    q, kc, vc = _dec_inputs(2, 64, 8, 1, 64, cuda)[:3]
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match="no backward"):
        dec_ops.decode_attention(q, kc, vc, 10)
    with torch.no_grad():
        dec_ops.decode_attention(q, kc, vc, 10)
    x = _randn((2, 8, 8, 32), 1, cuda).requires_grad_()
    s, b = _randn(32, 2, cuda), _randn(32, 3, cuda)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.groupnorm_silu(x, s, b, 8)
    with torch.no_grad():
        ops.groupnorm_silu(x, s, b, 8)
    torch.cuda.synchronize()


@pytest.mark.parametrize("remat", ["none", "block"])
def test_full_width_train_step_leaves_no_grad_none(cuda, remat):
    """Two layers of TinyLlama at full width (d 2048, 32/4 heads, vocab
    32000), one AdamW step at B=2, S=128 on the card: every param leaf
    gets a finite, non-zero gradient; launches 5 rmsnorm and 2 flash a
    forward, and with remat="block" the recompute's 4 and 2 more."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train
    from repro_torch.training.data import DataConfig, batches
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), num_layers=2)
    sch = map_schema(lambda p, _: p if p.init in ("ones", "zeros")
                     else P(p.shape, p.axes, scale=0.02),
                     api.get_model(cfg).schema(cfg))
    params = init_params(sch, torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    toks, labels = next(batches(DataConfig(cfg.vocab_size, 128, 2)))
    n = (rms_ops.launches, fa_ops.launches)
    _, state, m = train.make_train_step(cfg, RunConfig(remat=remat))(
        params, opt.init_state(params), torch.as_tensor(toks, device=cuda),
        torch.as_tensor(labels, device=cuda))
    torch.cuda.synchronize()
    extra = (4, 2) if remat == "block" else (0, 0)
    assert (rms_ops.launches - n[0], fa_ops.launches - n[1]) == \
        (5 + extra[0], 2 + extra[1])
    assert int(state["step"]) == 1 and math.isfinite(float(m["loss"]))
    for p in opt.leaves(params):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
        assert float(p.grad.abs().max()) > 0


def test_zamba2_train_step_through_ssd_scan(cuda):
    """One AdamW step of the narrow zamba2 (D = 80, two groups) on the
    card: launches per forward 4 ssd_scan, 2 flash and 13 rmsnorm, all
    through their Functions; every param leaf gets a finite gradient,
    and the loss and every gradient leaf agree with the CPU's (plain
    versions) within 1e-3 x the leaf's largest |g|."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train
    sch = map_schema(lambda p, _: p if p.init in ("ones", "zeros")
                     else P(p.shape, p.axes, scale=0.05), zamba2.schema(D80))
    params = init_params(sch, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, D80.vocab_size, (2, 65)), dtype=torch.int64)
    grads = {}
    for dev in ("cpu", cuda):
        p = train.trainable(opt.tree_map(
            lambda t: t.to(dev, copy=True), params))
        n = (ssd_ops.launches, fa_ops.launches, rms_ops.launches)
        loss, _ = train.make_loss_fn(D80, RunConfig())(
            p, toks[:, :-1].to(dev), toks[:, 1:].to(dev))
        loss.backward()
        grads[str(dev)] = (float(loss.detach()),
                           [q.grad.cpu() for q in opt.leaves(p)])
        if dev == cuda:
            assert (ssd_ops.launches - n[0], fa_ops.launches - n[1],
                    rms_ops.launches - n[2]) == (4, 2, 13)
    (lc, gc), (lg, gg) = grads["cpu"], grads[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-4)
    for a, b in zip(gg, gc, strict=True):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-3 * float(b.abs().max()))


# -- the planner's device engine ---------------------------------------------

def test_planner_engine_card_matches_cpu(cuda):
    """``plan_many`` and ``stacking(engine="torch")`` on the card within
    1e-9 mean FID of the same calls on the CPU (repro_torch.core.
    torchplan; the card's float64 pow may differ in the last ulp)."""
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.quality_model import PowerLawFID
    from repro_torch.core.service import make_scenario
    from repro_torch.core.stacking import stacking
    from repro_torch.core.torchplan import device_scope, plan_many
    D, Q = DelayModel(), PowerLawFID()
    taus = np.random.default_rng(2).uniform(7, 20, size=(200, 20))
    on_card = plan_many(taus, delay=D, quality=Q)
    with device_scope("cpu"):
        on_cpu = plan_many(taus, delay=D, quality=Q)
    np.testing.assert_allclose(on_card.mean_fid, on_cpu.mean_fid, rtol=0,
                               atol=1e-9)
    scn = make_scenario(K=300, seed=0)
    tp = {s.id: s.deadline - 0.4 for s in scn.services}
    ids = [s.id for s in scn.services]
    card = stacking(scn.services, tp, D, Q, engine="torch")
    with device_scope("cpu"):
        cpu = stacking(scn.services, tp, D, Q, engine="torch")
    card.validate(gen_deadlines=tp)
    assert abs(Q.mean_fid([card.steps_completed[k] for k in ids])
               - Q.mean_fid([cpu.steps_completed[k] for k in ids])) < 1e-9


# -- many edge servers: the fleet and the online facade ----------------------

def test_fleet_epoch_on_card_matches_vec(cuda):
    """``simulate_fleet(engine="torch")`` with every epoch's replans in
    one ``torchplan.replan_many`` call on the card: within 1e-9 mean FID
    of the vec engine, counts equal, one planner call an epoch."""
    from repro_torch.core import fleet, traffic
    from repro_torch.core.torchplan import kernels as pk
    cells = [fleet.FleetCell(bandwidth_hz=2e6,
                             process=traffic.PoissonProcess(5.0))
             for _ in range(24)]
    scn = fleet.FleetScenario(cells=cells, horizon=30.0, seed=1)
    vec = fleet.simulate_fleet(scn, engine="vec", allocator="inv_se")
    r0 = pk.READS["count"]
    got = fleet.simulate_fleet(scn, engine="torch", allocator="inv_se")
    assert pk.READS["count"] > r0               # it ran on the engine
    assert abs(got.mean_fid - vec.mean_fid) < 1e-9
    for k in ("arrivals", "admitted", "rejected", "completed", "replans",
              "peak_live_rows"):
        assert getattr(got, k) == getattr(vec, k), k
    assert got.planner_calls == 64 < vec.planner_calls


def test_online_execute_on_card_replays_the_simulated_batches(cuda):
    """``OnlineProvisioner(execute=True)`` on SMOKE on the card: the
    replayed batches are the simulated ones, images finite and within
    1e-3 of the same replay on the CPU (the parity phase's tolerance),
    ``unet.gn_silu_calls(SMOKE)`` groupnorm_silu launches a forward."""
    from repro_torch.api import DiffusionWorkload, OnlineProvisioner
    from repro_torch.core.service import make_scenario
    params = _smoke_executor("cpu").params
    scn = make_scenario(K=3, tau_min=1.5, tau_max=3.0, arrival_rate=2.0,
                        seed=2)
    lat = _latents({k: 1 for k in range(3)})
    reps = {}
    for dev in ("cuda", "cpu"):
        wl = DiffusionWorkload(cfg=SMOKE, params=params, device=dev)
        ops.launches = 0
        reps[dev] = OnlineProvisioner(
            scn, workload=wl, scheduler="stacking", allocator="inv_se",
            engine="torch", device=dev, execute=True).run(latents=lat)
        if dev == "cuda":
            launches = ops.launches
    card, cpu = reps["cuda"], reps["cpu"]
    batches = card.result.executed_batches
    assert batches == cpu.result.executed_batches and len(batches) > 1
    assert [x for x, _ in card.timings] == [len(ids) for _, ids in batches]
    assert launches == unet.gn_silu_calls(SMOKE) * len(batches)
    for k, img in cpu.content.items():
        assert np.isfinite(card.content[k]).all()
        np.testing.assert_allclose(card.content[k], img, rtol=0,
                                   atol=1e-3)


# -- the MoE path: deepseek-moe-16b and qwen3-moe-30b-a3b at head dim 128 --

# (B, S, H, KV): prefill at prompt 128 and the calibration's prompt 32 at
# B = 16; deepseek G = 1, qwen3 G = 8
MOE_ATTN = [(8, 128, 16, 16), (16, 32, 16, 16), (8, 128, 32, 4),
            (16, 32, 32, 4)]
# the decode steps' (B, cache, H, KV) against a 512-token cache
MOE_DEC = [(8, 512, 16, 16), (16, 512, 16, 16), (8, 512, 32, 4),
           (16, 512, 32, 4)]
# rmsnorm rows: the layers' d = 2048, qwen3's per-head q/k norm over 128
MOE_RMS = [(16, 128, 2048), (8, 1, 2048), (8, 128, 32, 128),
           (8, 128, 4, 128), (16, 1, 32, 128), (16, 1, 4, 128)]


@pytest.mark.parametrize("B,S,H,KV", MOE_ATTN)
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_at_the_moe_shapes(cuda, B, S, H, KV, window,
                                           dtype):
    dt = DTYPES[dtype][0]
    q = _randn((B, S, H, 128), 11, cuda, dt)
    k = _randn((B, S, KV, 128), 12, cuda, dt)
    v = _randn((B, S, KV, 128), 13, cuda, dt)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    _close(got, attention_ref(q, k, v, causal=True, window=window), dtype)


@pytest.mark.parametrize("B,S,H,KV", MOE_DEC)
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("q_dtype,c_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
def test_decode_attention_at_the_moe_shapes(cuda, B, S, H, KV, window,
                                            q_dtype, c_dtype):
    q = _randn((B, 1, H, 128), 14, cuda, DTYPES[q_dtype][0])
    kc = _randn((B, S, KV, 128), 15, cuda, DTYPES[c_dtype][0])
    vc = _randn((B, S, KV, 128), 16, cuda, DTYPES[c_dtype][0])
    cur = torch.tensor(np.random.default_rng(B + H).integers(1, S + 1, B),
                       dtype=torch.int32, device=cuda)
    before = dec_ops.launches
    got = dec_ops.decode_attention(q, kc, vc, cur, window=window)
    torch.cuda.synchronize()
    assert dec_ops.launches == before + 1
    _close(got, decode_attention_ref(q, kc, vc, cur, window=window),
           "bfloat16" if "bfloat16" in (q_dtype, c_dtype) else "float32")


@pytest.mark.parametrize("shape", MOE_RMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_at_the_moe_shapes(cuda, shape, dtype):
    x = _randn(shape, 17, cuda, DTYPES[dtype][0])
    s = _randn(shape[-1:], 18, cuda)
    before = rms_ops.launches
    got = rms_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    _close(got, rmsnorm_ref(x, s), dtype)


QWEN3_D128 = dataclasses.replace(
    smoke_variant(get_config("qwen3-moe-30b-a3b")), head_dim=128)


def test_moe_decode_step_on_card_matches_cpu(cuda):
    """Prefill and one decode step of qwen3's smoke variant at head dim
    128 (routed experts, q/k norm; float32 cache): the kernels on the
    card, the plain versions on the CPU, 4L+1 rmsnorm a forward; the
    first layer's routing of the prompt equal on both."""
    from repro_torch.models import moe
    cfg, run = QWEN3_D128, RunConfig(kv_cache_dtype="float32")
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 16)), dtype=torch.int64)
    x = torch.randn((3, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    outs = {}
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        n = (fa_ops.launches, dec_ops.launches, rms_ops.launches)
        logits, cache = api.make_prefill_step(cfg, run, 32)(p, toks.to(dev))
        step, cache = api.make_decode_step(cfg, run)(
            p, toks[:, -1:].to(dev), cache)
        tok, gate, _ = moe.route(cfg, x.to(dev),
                                 p["layers"]["moe"]["router"][0])
        outs[str(dev)] = (logits.cpu(), step.cpu(), tok.cpu(), gate.cpu())
        if dev == cuda:
            L = cfg.num_layers
            assert (fa_ops.launches - n[0], dec_ops.launches - n[1],
                    rms_ops.launches - n[2]) == (L, L, 2 * (4 * L + 1))
    (lc, sc, tc, gc), (lg, sg, tg, gg) = outs["cpu"], outs[str(cuda)]
    assert torch.equal(tg, tc)
    torch.testing.assert_close(gg, gc, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lg, lc, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(sg, sc, atol=1e-3, rtol=1e-3)


# -- the remaining families: whisper-tiny, xlstm-125m, the VLM ---------------

# flash_attention without a mask, (B, Sq, Skv, H, KV, D): whisper's
# encoder over its 1500 frames and its cross prefill over them (G = 1,
# D = 64), the VLM's cross prefill over 1601 vision tokens (G = 8,
# D = 128), and Sq > Skv (the VLM smoke's 32 over 16, and ragged tiles)
FAMILY_ATTN = [(2, 1500, 1500, 6, 6, 64), (8, 128, 1500, 6, 6, 64),
               (2, 32, 1500, 6, 6, 64), (2, 128, 1601, 64, 8, 128),
               (8, 32, 1601, 64, 8, 128), (2, 32, 16, 4, 4, 64),
               (3, 100, 37, 8, 2, 64), (1, 200, 64, 4, 4, 128)]
# decode over the cross caches, (B, S, H, KV, D): neither S is a multiple
# of the kernel's 64-row tile
FAMILY_DEC = [(8, 1500, 6, 6, 64), (1, 1500, 6, 6, 64),
              (8, 1601, 64, 8, 128), (1, 1601, 64, 8, 128)]
# rmsnorm rows: the VLM's d = 8192, the mLSTM's 1536 and the sLSTM's 768
FAMILY_RMS = [(8, 128, 8192), (8, 1, 8192), (8, 128, 1536), (8, 1, 1536),
              (8, 128, 768), (8, 1, 768), (1, 32, 8192)]


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", FAMILY_ATTN)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_unmasked_at_the_family_shapes(cuda, B, Sq, Skv, H,
                                                       KV, D, dtype):
    dt = DTYPES[dtype][0]
    q = _randn((B, Sq, H, D), 21, cuda, dt)
    k = _randn((B, Skv, KV, D), 22, cuda, dt)
    v = _randn((B, Skv, KV, D), 23, cuda, dt)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    _close(got, attention_ref(q, k, v, causal=False), dtype)


@pytest.mark.parametrize("B,S,H,KV,D", FAMILY_DEC)
@pytest.mark.parametrize("full", [True, False], ids=["whole", "random"])
@pytest.mark.parametrize("q_dtype,c_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
def test_decode_attention_over_the_cross_caches(cuda, B, S, H, KV, D, full,
                                                q_dtype, c_dtype):
    """cur_len the whole cache (the cross decode's) or random."""
    q, kc, vc = _dec_inputs(B, S, H, KV, D, cuda, q_dtype, c_dtype)
    cur = [S] * B if full else \
        np.random.default_rng(S + B).integers(1, S + 1, B).tolist()
    _dec_check(q, kc, vc, cur)


@pytest.mark.parametrize("shape", FAMILY_RMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_at_the_family_shapes(cuda, shape, dtype):
    x = _randn(shape, 24, cuda, DTYPES[dtype][0])
    s = _randn(shape[-1:], 25, cuda)
    before = rms_ops.launches
    got = rms_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    _close(got, rmsnorm_ref(x, s), dtype)


def _family_params(cfg):
    """Smoke params drawn with std 0.05 (norm scales and biases as in
    the schema; at the reference's init every softmax is one-hot and
    rounding would pick the winning key), the VLM's gates uniform in
    [0.5, 1] (zeros would leave its cross layers out)."""
    from repro_torch.models import api
    sch = map_schema(lambda p, _: p if p.init in ("ones", "zeros")
                     else P(p.shape, p.axes, scale=0.05),
                     api.get_model(cfg).schema(cfg))
    params = init_params(sch, torch.Generator().manual_seed(0), "cpu")
    if cfg.cross_attn_every:
        cross = params["groups"]["cross"]
        gen = torch.Generator().manual_seed(1)
        for g in ("gate_attn", "gate_mlp"):
            cross[g] = 0.5 + 0.5 * torch.rand(cross[g].shape, generator=gen)
    return params


@pytest.mark.parametrize("arch,launches", [
    # (flash, decode, rmsnorm) for one prefill and one decode step
    ("whisper-tiny", (6, 4, 0)),            # 2 encoder + 2x2 decoder
    ("xlstm-125m", (0, 0, 4)),              # one rmsnorm a block
    ("llama-3.2-vision-90b", (2, 2, 10))])  # one self, one cross layer
def test_family_on_card_matches_cpu(cuda, arch, launches):
    """Prefill and two greedy decode steps of each family's smoke
    variant, batch 3 against batch-1 extras drawn from a seed (expanded
    by the engine's rule), float32 cache: the kernels on the card, the
    plain versions on the CPU, within 1e-3; launches exact."""
    from repro_torch.serving.engine import ServingEngine
    cfg = smoke_variant(get_config(arch))
    params = _family_params(cfg)
    M = cfg.num_audio_frames or cfg.num_vision_tokens
    extras = None
    if M:
        key = "audio_frames" if cfg.family == "audio" else "vision_embeds"
        extras = {key: torch.randn((1, M, cfg.d_model),
                                   generator=torch.Generator().manual_seed(2))}
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (3, 16))
    run = RunConfig(kv_cache_dtype="float32")
    outs = {}
    for dev in ("cpu", cuda):
        eng = ServingEngine(cfg, params, run, 32, extras=extras, device=dev)
        n = (fa_ops.launches, dec_ops.launches, rms_ops.launches)
        logits, cache = eng.prefill(toks)
        step, cache = eng.decode(torch.as_tensor(toks[:, -1:], device=dev),
                                 cache)
        if dev == cuda:
            assert (fa_ops.launches - n[0], dec_ops.launches - n[1],
                    rms_ops.launches - n[2]) == launches
        step2, _ = eng.decode(step[:, -1].argmax(-1)[:, None], cache)
        outs[str(dev)] = [t.cpu() for t in (logits, step, step2)]
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _named_leaves(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


@pytest.mark.parametrize("arch,remat,launches", [
    # (rmsnorm, flash, ssd_scan) of one step of the smoke variant: the
    # forward's, then the remat recompute's
    ("deepseek-moe-16b", "none", (5, 2, 0)),       # 2L+1 norms, L flash
    ("whisper-tiny", "block", (0, 6 + 4, 0)),      # 2 enc + 2x2 dec
    ("xlstm-125m", "group", (2 + 2, 0, 0)),        # one norm a block
    ("llama-3.2-vision-90b", "group", (5 + 4, 2 + 2, 0)),
    ("zamba2-2.7b", "group", (7 + 6, 1 + 1, 2 + 2))])
def test_family_train_step_on_card(cuda, arch, remat, launches):
    """One AdamW step of each family's smoke variant (``_family_params``
    weights, extras drawn from a seed), B=2, S=64, on the card and on
    the CPU: the kernels launch through their Functions (exact counts,
    the recompute's included), every param leaf gets a finite gradient
    (none left None, no detached output), and the loss and every
    gradient leaf agree with the CPU's (plain versions) within 1e-3 x
    the leaf's largest |g|; the sLSTM's input-gate bias, whose gradient
    is zero in exact arithmetic, within 1e-6 of the largest |g| on both
    sides."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train
    cfg = smoke_variant(get_config(arch))
    params = _family_params(cfg)
    M = cfg.num_audio_frames or cfg.num_vision_tokens
    extras = None
    if M:
        key = "audio_frames" if cfg.family == "audio" else "vision_embeds"
        extras = {key: torch.randn((2, M, cfg.d_model),
                                   generator=torch.Generator().manual_seed(2))}
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 65)), dtype=torch.int64)
    out = {}
    for dev in ("cpu", cuda):
        p = opt.tree_map(lambda t: t.to(dev, copy=True), params)
        n = (rms_ops.launches, fa_ops.launches, ssd_ops.launches)
        p, state, m = train.make_train_step(cfg, RunConfig(remat=remat))(
            p, opt.init_state(p), toks[:, :-1].to(dev), toks[:, 1:].to(dev),
            extras)
        if dev == cuda:
            torch.cuda.synchronize()
            assert (rms_ops.launches - n[0], fa_ops.launches - n[1],
                    ssd_ops.launches - n[2]) == launches
        assert int(state["step"]) == 1 and math.isfinite(float(m["loss"]))
        out[str(dev)] = (float(m["loss"]), {k: q.grad.cpu() for k, q in
                                            _named_leaves(p)})
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert lg == pytest.approx(lc, rel=1e-4)
    top = max(float(g.abs().max()) for g in gc.values())
    for key, want in gc.items():
        got = gg[key]
        assert bool(torch.isfinite(got).all()), key
        if key == "groups/slstm/bi":
            assert max(float(got.abs().max()),
                       float(want.abs().max())) <= 1e-6 * top
            continue
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-3 * float(want.abs().max()),
                                   msg=key)


# -- the last dense configs: codeqwen1.5-7b, minitron-4b, granite-34b -------

# (B, cache, H, KV) of decode at G = 3 (minitron), 33, 48 (granite's
# multi-query), 64 (the most one block holds) and 96 (two blocks of
# heads a KV head)
DENSE_DEC = [(B, S, H, KV) for B in (1, 8)
             for S, H, KV in ((512, 24, 8), (300, 33, 1), (512, 48, 1),
                              (700, 128, 2), (200, 96, 1))]


@pytest.mark.parametrize("B,S,H,KV", DENSE_DEC)
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("q_dtype,c_dtype", [("float32", "float32"),
                                             ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
def test_decode_attention_at_large_groups(cuda, B, S, H, KV, D, window,
                                          q_dtype, c_dtype):
    q = _randn((B, 1, H, D), 21, cuda, DTYPES[q_dtype][0])
    kc = _randn((B, S, KV, D), 22, cuda, DTYPES[c_dtype][0])
    vc = _randn((B, S, KV, D), 23, cuda, DTYPES[c_dtype][0])
    cur = torch.tensor(np.random.default_rng(B + H + D).integers(1, S + 1, B),
                       dtype=torch.int32, device=cuda)
    before = dec_ops.launches
    got = dec_ops.decode_attention(q, kc, vc, cur, window=window)
    torch.cuda.synchronize()
    assert dec_ops.launches == before + 1
    _close(got, decode_attention_ref(q, kc, vc, cur, window=window),
           "bfloat16" if "bfloat16" in (q_dtype, c_dtype) else "float32")


# (B, S, H, KV) of the prefills at prompt 128 and the calibration's 32 at
# B = 16: codeqwen (MHA), minitron (G = 3), granite (G = 48, KV = 1)
DENSE_ATTN = [(8, 128, 32, 32), (16, 32, 32, 32), (8, 128, 24, 8),
              (16, 32, 24, 8), (8, 128, 48, 1), (16, 32, 48, 1)]


@pytest.mark.parametrize("B,S,H,KV", DENSE_ATTN)
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_at_the_dense_shapes(cuda, B, S, H, KV, window,
                                             dtype):
    dt = DTYPES[dtype][0]
    q = _randn((B, S, H, 128), 24, cuda, dt)
    k = _randn((B, S, KV, 128), 25, cuda, dt)
    v = _randn((B, S, KV, 128), 26, cuda, dt)
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    _close(got, attention_ref(q, k, v, causal=True, window=window), dtype)


@pytest.mark.parametrize("Sq,Skv,q_offset", [(16, 80, 0), (16, 80, 64),
                                              (48, 40, 0), (96, 33, 7),
                                              (64, 64, 5)])
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_continuation(cuda, Sq, Skv, q_offset, window,
                                      dtype):
    """Continuation attention: query i at key position q_offset + i, at
    Sq < Skv and Sq > Skv, causal and windowed (rows whose keys are all
    masked give 0 in the kernel, the mean of v in the plain version:
    the windows here leave every row a key)."""
    dt = DTYPES[dtype][0]
    q = _randn((2, Sq, 8, 64), 27, cuda, dt)
    k = _randn((2, Skv, 2, 64), 28, cuda, dt)
    v = _randn((2, Skv, 2, 64), 29, cuda, dt)
    if window and Sq + q_offset - window >= Skv:
        window = Sq + q_offset - Skv + 1
    before = fa_ops.launches
    got = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                 q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.launches == before + 1
    _close(got, attention_ref(q, k, v, causal=True, window=window,
                              q_offset=q_offset), dtype)


@pytest.mark.parametrize("shape", [(16, 32, 4096), (8, 128, 4096),
                                   (8, 1, 4096), (16, 1, 4096)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_on_rows_of_4096(cuda, shape, dtype):
    x = _randn(shape, 30, cuda, DTYPES[dtype][0])
    s = _randn(shape[-1:], 31, cuda)
    before = rms_ops.launches
    got = rms_ops.rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    _close(got, rmsnorm_ref(x, s), dtype)



@pytest.mark.parametrize("arch,over", [
    ("codeqwen1.5-7b", {}), ("minitron-4b", {}), ("granite-34b", {}),
    ("granite-34b", dict(num_heads=48, num_kv_heads=1, head_dim=32))],
    ids=["codeqwen", "minitron", "granite", "granite-g48"])
def test_dense_config_on_card_matches_cpu(cuda, arch, over):
    """Prefill and one decode step of each new config's smoke variant
    (granite's also at G = 48 on one KV head), weights at std 0.05,
    float32 cache: the kernels on the card, the plain versions on the
    CPU, within 1e-3; launches exact (a layernorm config launches no
    rmsnorm)."""
    cfg = dataclasses.replace(smoke_variant(get_config(arch)), **over)
    params = _family_params(cfg)
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 16)), dtype=torch.int64)
    run = RunConfig(kv_cache_dtype="float32")
    outs = {}
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        n = (fa_ops.launches, dec_ops.launches, rms_ops.launches)
        logits, cache = api.make_prefill_step(cfg, run, 32)(p, toks.to(dev))
        step, _ = api.make_decode_step(cfg, run)(p, toks[:, -1:].to(dev),
                                                 cache)
        if dev == cuda:
            L = cfg.num_layers
            norms = 2 * (2 * L + 1) if cfg.norm == "rmsnorm" else 0
            assert (fa_ops.launches - n[0], dec_ops.launches - n[1],
                    rms_ops.launches - n[2]) == (L, L, norms)
        outs[str(dev)] = (logits.cpu(), step.cpu())
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("knobs", [
    dict(decode_inplace_cache=True),
    dict(decode_inplace_cache=True, decode_uniform_pos=True),
    dict(decode_window=8, decode_slice_reads=True),
    dict(decode_inplace_cache=True, decode_window=8,
         decode_slice_reads=True)],
    ids=["inplace", "inplace-uniform", "slice", "inplace-slice"])
@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_decode_knobs_on_card_match_cpu(cuda, knobs, kv_dtype):
    """The serving knobs on the narrow GQA model, rows at different
    positions, two decode steps: card against CPU within 1e-3 (float32
    cache) or 2e-2 (bfloat16); the in-place branch launches no
    decode_attention, the slice reads one a layer over the window's
    contiguous copy."""
    cfg = GQA
    params = _family_params(cfg)
    toks = torch.tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (3, 16)), dtype=torch.int64)
    run = RunConfig(kv_cache_dtype=kv_dtype, **knobs)
    tol = 1e-3 if kv_dtype == "float32" else 2e-2
    outs = {}
    for dev in ("cpu", cuda):
        p = _tree_to(params, dev)
        _, cache = api.make_prefill_step(cfg, run, 32)(p, toks.to(dev))
        cache = dict(cache, pos=torch.tensor([16, 13, 11], dtype=torch.int32,
                                             device=dev))
        n = dec_ops.launches
        tok, got = toks[:, -1:].to(dev), []
        for _ in range(2):
            logits, cache = api.make_decode_step(cfg, run)(p, tok, cache)
            got.append(logits.cpu())
            tok = logits[:, -1].argmax(-1)[:, None]
        if dev == cuda:
            launched = dec_ops.launches - n
            assert launched == (0 if run.decode_inplace_cache
                                else 2 * cfg.num_layers)
        outs[str(dev)] = got
    for got, want in zip(outs[str(cuda)], outs["cpu"]):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


# -- sharding: the one-card NCCL mesh -----------------------------------------

@pytest.fixture
def one_card_mesh(cuda, tmp_path):
    """A (data 1, model 1) mesh over an NCCL world of one (file store
    under tmp_path), torn down after the test."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(model=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b",
                                  "zamba2-2.7b", "xlstm-125m",
                                  "whisper-tiny", "llama-3.2-vision-90b"])
def test_sharded_one_card_mesh_matches_unsharded(one_card_mesh, arch):
    """A smoke prefill and 3 greedy decode steps sharded on the one-card
    mesh (DTensor params, the kernels reached through local_map; whisper
    and the VLM over extras drawn from a seed) against the unsharded run
    on the same params: tokens equal, logits within 1e-5 of the largest,
    each kernel's launch count rising by what the unsharded run
    launches, and every kernel of the family's path launched."""
    from repro_torch.config import sharding_rules_for
    from repro_torch.launch import shardings as shd
    from repro_torch.launch.mesh import mesh_axis_sizes
    from repro_torch.models.params import use_rules
    cfg = smoke_variant(get_config(arch))
    run = RunConfig(kv_cache_dtype="float32")
    rules = sharding_rules_for(cfg, mesh_axis_sizes(one_card_mesh), run)
    params = _tree_to(_family_params(cfg), "cuda")
    toks = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 16)), dtype=torch.int64, device="cuda")
    M = cfg.num_audio_frames or cfg.num_vision_tokens
    extras = None if not M else {
        "audio_frames" if cfg.family == "audio" else "vision_embeds":
        torch.randn((4, M, cfg.d_model), generator=torch.Generator(
        ).manual_seed(7)).to("cuda")}
    ops_ = {"rmsnorm": rms_ops, "flash_attention": fa_ops,
            "decode_attention": dec_ops, "ssd_scan": ssd_ops}
    outs, launched = {}, {}
    for key in ("plain", "sharded"):
        p = params
        if key == "sharded":
            p = shd.distribute(params, one_card_mesh,
                               shd.model_param_pspecs(cfg, rules, False))
        before = {n: m.launches for n, m in ops_.items()}
        got = []
        with use_rules(rules if key == "sharded" else None), \
                torch.no_grad():
            logits, cache = api.make_prefill_step(cfg, run, 24)(p, toks,
                                                                extras)
            for _ in range(3):
                full = logits.full_tensor() if key == "sharded" else logits
                got.append(full[:, -1].float().cpu())
                tok = full[:, -1].argmax(-1)[:, None]
                logits, cache = api.make_decode_step(cfg, run)(
                    p, tok, cache, extras)
        launched[key] = {n: m.launches - before[n] for n, m in ops_.items()}
        outs[key] = got
    assert launched["sharded"] == launched["plain"]
    llm = {"rmsnorm", "flash_attention", "decode_attention"}
    expected = {"dense": llm, "moe": llm, "vlm": llm,
                "hybrid": llm | {"ssd_scan"}, "ssm": {"rmsnorm"},
                "audio": {"flash_attention", "decode_attention"}}
    assert {n for n, v in launched["sharded"].items() if v > 0} \
        == expected[cfg.family]
    if cfg.family == "hybrid":
        assert launched["sharded"]["ssd_scan"] == cfg.num_layers
    for got, want in zip(outs["sharded"], outs["plain"]):
        assert torch.equal(got.argmax(-1), want.argmax(-1))
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def test_ssd_scan_through_local_call_on_the_card(one_card_mesh):
    """``models.ssm.ssd_chunked`` on DTensors (heads on ``model``, B and
    C whole) reaches the kernel through ``local_map``: one launch, the
    output and its gradients equal to the kernel's on the plain tensors,
    each a DTensor placed as its input; the wrapper itself refuses the
    DTensors."""
    from torch.distributed.tensor import Shard
    from repro_torch.models.params import PS, shard_as
    from repro_torch.models.ssm import ssd_chunked
    B, S, H, Pd, N, Q = 2, 64, 4, 16, 8, 32
    x = _randn((B, S, H, Pd), 1, "cuda")
    a = -torch.rand((B, S, H), generator=torch.Generator(
        device="cuda").manual_seed(2), device="cuda") * 0.2
    b, c = _randn((B, S, N), 3, "cuda"), _randn((B, S, N), 4, "cuda")
    h0 = _randn((B, H, Pd, N), 5, "cuda")
    plain = [t.clone().requires_grad_() for t in (x, a, b, c, h0)]
    y, h = ssd_chunked(*plain, chunk=Q)
    (y.square().sum() + h.sum()).backward()
    specs = (PS("data", None, "model"), PS("data", None, "model"),
             PS("data"), PS("data"), PS("data", "model"))
    leaves = [shard_as(t, one_card_mesh, sp).detach().requires_grad_()
              for t, sp in zip((x, a, b, c, h0), specs)]
    with pytest.raises(TypeError, match="local_map"):
        ssd_ops.ssd_scan(*leaves, chunk=Q)
    before = ssd_ops.launches
    yd, hd = ssd_chunked(*leaves, chunk=Q)
    assert ssd_ops.launches == before + 1
    assert tuple(yd.placements) == (Shard(0), Shard(2))
    assert tuple(hd.placements) == (Shard(0), Shard(1))
    (yd.square().sum() + hd.sum()).backward()
    assert torch.equal(yd.full_tensor(), y) and torch.equal(
        hd.full_tensor(), h)
    for t, d in zip(plain, leaves):
        assert torch.allclose(d.grad.full_tensor(), t.grad, rtol=0,
                              atol=1e-6 * float(t.grad.abs().max()))
