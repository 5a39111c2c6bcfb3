"""The plain references against the port at smoke sizes on the CPU:
the U-Net's noise and DDIM chains, and deepseek's decode logits after a
prefill and decode steps over a bfloat16 cache, on the benchmark's own
weights; the weights drawn again are the same; the prompt rule is the
workload's."""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PB = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PB))

from harness import frozen  # noqa: E402


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name.replace("-", "_"), PB / "configs" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


UNET = _load("ddim-cifar10")
MOE = _load("deepseek-moe-16b")
DDIM_SMOKE = dict(json.loads((PB / "configs" / "ddim-cifar10.json")
                             .read_text()),
                  image_size=16, base_channels=32, channel_mults=[1, 2],
                  num_res_blocks=1, attn_resolutions=[8], num_groups=8)
MOE_SMOKE = dict(json.loads((PB / "configs" / "deepseek-moe-16b.json")
                            .read_text()),
                 hidden_size=128, num_attention_heads=2,
                 num_key_value_heads=2, num_hidden_layers=2,
                 moe_intermediate_size=32, n_routed_experts=8,
                 num_experts_per_tok=2, n_shared_experts=1, vocab_size=256,
                 initializer_range=0.2)


def _unet_cfg(c):
    from repro_torch.configs.ddim_cifar10 import UNetConfig
    return UNetConfig(image_size=c["image_size"],
                      base_channels=c["base_channels"],
                      channel_mults=tuple(c["channel_mults"]),
                      num_res_blocks=c["num_res_blocks"],
                      attn_resolutions=tuple(c["attn_resolutions"]),
                      num_groups=c["num_groups"])


def test_weights_drawn_again_equal():
    a = UNET.make_weights(DDIM_SMOKE, 2**35 + 1, "cpu")
    b = UNET.make_weights(DDIM_SMOKE, 2**35 + 1, "cpu")
    assert torch.equal(a["downs"][1]["res"][0]["res"]["conv1"],
                       b["downs"][1]["res"][0]["res"]["conv1"])
    c = MOE.make_weights(MOE_SMOKE, 5, "cpu")
    d = MOE.make_weights(MOE_SMOKE, 5, "cpu")
    assert torch.equal(c["layers"]["moe"]["down"], d["layers"]["moe"]["down"])


@pytest.mark.parametrize("seed", [0, 3])
def test_unet_and_ddim_chain(seed):
    from repro_torch.diffusion import ddim, unet
    cfg = _unet_cfg(DDIM_SMOKE)
    w = UNET.make_weights(DDIM_SMOKE, seed, "cpu")
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((3, 16, 16, 3), generator=g)
    t = torch.tensor([999.0, 400.0, 3.0])
    want = unet.forward(cfg, w, x, t)
    got = UNET.eps(DDIM_SMOKE, w, x, t)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # a chain of 5 steps and one of 3 retargeted to 4, in one batch
    s5 = frozen.ddim_timesteps(5)
    s3 = frozen.ddim_timesteps(3)
    s_rt = s3[:1] + frozen.retarget_timesteps(s3[1], 4)
    scheds = [[(a, b) for a, b in zip(s, s[1:] + [-1])]
              for s in (s5, s_rt)]
    out = UNET.denoise(DDIM_SMOKE, w, x[:2], scheds)
    for i, sch in enumerate(scheds):
        xi = x[i:i + 1]
        for tn, tx in sch:
            xi = ddim.ddim_step(lambda a, b: unet.forward(cfg, w, a, b), xi,
                                torch.tensor([tn]), torch.tensor([tx]))
        assert (out[i] - xi[0]).abs().max() <= 1e-5 * xi.abs().max()


def test_prompt_rule_is_the_workloads():
    from repro_torch.api import DecodeWorkload
    wl = DecodeWorkload(prompt_len=16, init_seed=123456789, device="cpu")
    for k in (0, 5, 10**6 + 3):
        assert np.array_equal(wl._prompt(k, 256),
                              MOE.prompt(123456789, k, 256, 16))


@pytest.mark.parametrize("seed", [1, 2])
def test_moe_decode_logits(seed):
    import dataclasses
    from repro_torch.config import RunConfig, get_config
    from repro_torch.models import transformer
    c = MOE_SMOKE
    cfg = dataclasses.replace(
        get_config("deepseek-moe-16b"), num_layers=2, d_model=128,
        num_heads=2, num_kv_heads=2, d_ff=32, vocab_size=256,
        num_experts=8, experts_per_token=2, num_shared_experts=1,
        d_ff_expert=32)
    run = RunConfig(kv_cache_dtype="bfloat16", moe_capacity_factor=1.25)
    w = MOE.make_weights(c, seed, "cpu")
    P, steps = 16, 6
    prompts = [MOE.prompt(seed, k, 256, P) for k in range(2)]
    _, cache = transformer.prefill(cfg, w, torch.tensor(np.stack(prompts)),
                                   64, run)
    tok = torch.tensor([[p[-1]] for p in prompts])
    fed, got = [[int(p[-1])] for p in prompts], [[], []]
    for _ in range(steps):
        logits, cache = transformer.decode_step(cfg, w, tok, cache, run)
        for i in range(2):
            got[i].append(logits[i, -1])
        tok = logits[:, -1].argmax(-1, keepdim=True)
        for i in range(2):
            fed[i].append(int(tok[i, 0]))
    seqs = [torch.tensor(np.concatenate([prompts[i], fed[i][:steps]]))
            for i in range(2)]
    want = MOE.decode_logits(c, w, seqs, P)
    for i in range(2):
        g = torch.stack(got[i])
        assert (g - want[i]).abs().max() <= 1e-5 * want[i].abs().max()


def test_routed_distinct_ratio():
    """The reference's routing against the uniform-routing expectation
    the decode-step count charges: 1 where every row picks its own k
    experts at random, k over the expectation where every row picks the
    same k."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "driver_decode", PB / "drivers" / "decode.py")
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    E, k, K, P, n = 64, 6, 8, 4, 4000
    rng = np.random.default_rng(3)
    lens = [P + n] * 8
    T = sum(lens)
    uniform = [np.argsort(rng.random((T, E)), axis=1)[:, :k]
               for _ in range(2)]
    assert drv.distinct_ratio(uniform, lens, P, E, k, K) == \
        pytest.approx(1.0, abs=0.01)
    same = [np.tile(np.arange(k), (T, 1))]
    want = k / (E * (1 - (1 - k / E) ** 8))
    assert drv.distinct_ratio(same, lens, P, E, k, K) == \
        pytest.approx(want, rel=1e-12)


def test_decode_driver_reads_dense_and_moe_configs():
    """The decode driver builds the port's model from the file alone: a
    mixture where ``n_routed_experts`` > 0, a dense SwiGLU of width
    ``intermediate_size`` where the key is 0."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "driver_decode", PB / "drivers" / "decode.py")
    drv = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(drv)
    moe = drv.Driver(MOE_SMOKE, {}, None, 1, "cpu").model_config()
    assert moe.is_moe and moe.num_experts == 8 and moe.d_ff_expert == 32
    dense = drv.Driver(dict(MOE_SMOKE, n_routed_experts=0), {}, None, 1,
                       "cpu").model_config()
    assert not dense.is_moe
    assert dense.d_ff == MOE_SMOKE["intermediate_size"]
