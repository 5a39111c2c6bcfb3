"""Card-only checks of the port's CUDA kernels, against their plain
PyTorch versions on the same card.

Every test here is marked ``cuda`` and skips where torch sees no CUDA
device.  The file imports no jax, so it runs on a machine that has only
PyTorch:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's kernel-test ones: 2e-5 in float32, 2e-2
in bfloat16.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.ddim_cifar10 import SMOKE  # noqa: E402
from repro_torch.diffusion import unet  # noqa: E402
from repro_torch.diffusion.executor import BatchDenoisingExecutor  # noqa: E402
from repro_torch.kernels.groupnorm_silu import ops  # noqa: E402
from repro_torch.kernels.groupnorm_silu.ref import groupnorm_silu_ref  # noqa: E402
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
    return torch.device("cuda")


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
