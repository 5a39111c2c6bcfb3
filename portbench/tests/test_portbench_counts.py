"""The frozen counts read the same work as the port's own formulas at
the cells' shapes: ``groupnorm_silu``'s and ``decode_attention``'s
``cost(...)``, the U-Net's products (PyTorch's flop counter over the
port's forward) and the decode step's weights (the port's schema)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PB = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PB / "counts"))

import decode_attention as da_count  # noqa: E402
import decode_step  # noqa: E402
import groupnorm_silu as gn_count  # noqa: E402
import unet_flops  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.groupnorm_silu import ops as gn_ops  # noqa: E402

DDIM = json.loads((PB / "configs" / "ddim-cifar10.json").read_text())
DSMOE = json.loads((PB / "configs" / "deepseek-moe-16b.json").read_text())


@pytest.mark.parametrize("B", [1, 5, 16, 32])
def test_groupnorm_silu_cost(B):
    calls = gn_count.unet_calls(DDIM)
    assert len(calls) == 45
    for h, w, c in set(calls):
        x = torch.empty((B, h, w, c), device="meta")
        s = torch.empty((c,), device="meta")
        want = gn_ops.cost(x, s, s, DDIM["num_groups"])
        assert gn_count.cost(B, h, w, c) == (want.flops, want.bytes)
        assert gn_count.bound_s(B, h, w, c) == pytest.approx(
            want.ms * 1e-3, rel=1e-12)


@pytest.mark.parametrize("lens", [[129], [129] * 8, list(range(129, 161)),
                                  [512, 600, 130]])
@pytest.mark.parametrize("H,KV,D", [(16, 16, 128), (32, 4, 128),
                                    (32, 4, 64), (48, 1, 128)])
def test_decode_attention_cost(lens, H, KV, D):
    B, S = len(lens), 512
    q = torch.empty((B, 1, H, D))
    k = torch.empty((B, S, KV, D), dtype=torch.bfloat16)
    want = da_ops.cost(q, k, k, torch.tensor(lens, dtype=torch.int32))
    ops, nbytes, rate = da_count.cost(lens, S, H, KV, D)
    assert (ops, nbytes) == (want.flops, want.bytes)
    assert rate == want.ops_per_s / want.per_op
    assert da_count.bound_s(lens, S, H, KV, D) == pytest.approx(
        want.ms * 1e-3, rel=1e-12)


def test_unet_flops_match_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.ddim_cifar10 import CONFIG
    from repro_torch.diffusion import unet
    from repro_torch.models.params import init_params
    params = init_params(unet.schema(CONFIG),
                         torch.Generator().manual_seed(0), "cpu")
    x = torch.zeros((2, 32, 32, 3))
    t = torch.tensor([10.0, 500.0])
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        unet.forward(CONFIG, params, x, t)
    assert fc.get_total_flops() == 2 * unet_flops.forward_flops(DDIM)


def test_decode_step_weights_match_schema():
    from repro_torch.config import get_config
    from repro_torch.models import api
    from repro_torch.models.params import map_schema
    cfg = get_config("deepseek-moe-16b")
    sizes = {}
    map_schema(lambda p, path: sizes.__setitem__(path, int(np.prod(p.shape))),
               api.get_model(cfg).schema(cfg))
    routed = sum(v for k, v in sizes.items()
                 if k.split("/")[-1] in ("up", "gate", "down")
                 and "/moe/" in k)
    dense = sum(sizes.values()) - routed - sizes["/embed/tok"]
    assert sum(sizes.values()) == DSMOE["params"]
    # B rows of one token, each choosing all E experts: every weight
    # read once, the embedding's B rows, and no cache row
    E = DSMOE["n_routed_experts"]
    ops, nbytes = decode_step.step(dict(DSMOE, num_experts_per_tok=E),
                                   [0], 512)
    L, KV, hd = 28, 16, 128
    assert nbytes == 4 * (dense + routed + DSMOE["hidden_size"]) \
        + L * 2 * 1 * KV * hd * 2


def test_decode_step_dense_weights_match_schema():
    """A configuration without routed experts counts a dense SwiGLU:
    every weight of the port's dense schema read once."""
    from repro_torch.config import get_config
    from repro_torch.models import api
    from repro_torch.models.params import map_schema
    m = get_config("tinyllama-1.1b")
    sizes = {}
    map_schema(lambda p, path: sizes.__setitem__(path, int(np.prod(p.shape))),
               api.get_model(m).schema(m))
    cfg = {"hidden_size": m.d_model, "num_hidden_layers": m.num_layers,
           "num_attention_heads": m.num_heads,
           "num_key_value_heads": m.num_kv_heads,
           "intermediate_size": m.d_ff, "vocab_size": m.vocab_size}
    ops, nbytes = decode_step.step(cfg, [0], 512)
    weights = sum(sizes.values()) - sizes["/embed/tok"]
    hd = m.d_model // m.num_heads
    assert nbytes == 4 * (weights + m.d_model) \
        + m.num_layers * 2 * m.num_kv_heads * hd * 2
    assert ops == 2 * weights
