"""The port's copies of the transformer configs against the reference's:
``ModelConfig``, ``RunConfig``, TinyLlama's and Zamba2's ``CONFIG``,
``smoke_variant`` and ``TokenQuality`` are field-for-field equal
(``dataclasses.asdict`` ``==``), and the registry raises for an arch the
port does not run."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import config as jcfg  # noqa: E402
from repro.configs.tinyllama_1_1b import CONFIG as JAX_TINYLLAMA  # noqa: E402
from repro.configs.zamba2_2_7b import CONFIG as JAX_ZAMBA2  # noqa: E402
from repro.serving.engine import TokenQuality as JaxTokenQuality  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.configs.tinyllama_1_1b import CONFIG  # noqa: E402
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving.engine import TokenQuality  # noqa: E402


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _fields(cls):
    return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["ModelConfig", "RunConfig"])
def test_dataclass_fields_and_defaults_match(name):
    assert _fields(getattr(config, name)) == _fields(getattr(jcfg, name))


def test_tinyllama_config_matches():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(JAX_TINYLLAMA)
    assert config.get_config("tinyllama-1.1b") is CONFIG
    assert CONFIG.param_count() == JAX_TINYLLAMA.param_count()
    # the schema adds the 2L+1 norm scales the analytic count leaves out
    n = sum(int(np.prod(p.shape)) for p in _leaves(transformer.schema(CONFIG)))
    assert n == CONFIG.param_count() + 45 * 2048 == 1_100_048_384
    assert (CONFIG.q_per_kv, CONFIG.resolved_head_dim) == (8, 64)


def test_zamba2_config_matches():
    assert dataclasses.asdict(ZAMBA2) == dataclasses.asdict(JAX_ZAMBA2)
    assert config.get_config("zamba2-2.7b") is ZAMBA2
    assert ZAMBA2.param_count() == JAX_ZAMBA2.param_count()
    assert (ZAMBA2.resolved_head_dim, ZAMBA2.q_per_kv) == (80, 1)


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_smoke_variant_matches(arch):
    """The copied smoke_variant reduces every reference arch alike (each
    rebuilt from the reference's fields, registered in the port or
    not)."""
    ref = jcfg.get_config(arch)
    mine = config.ModelConfig(**dataclasses.asdict(ref))
    assert dataclasses.asdict(config.smoke_variant(mine)) \
        == dataclasses.asdict(jcfg.smoke_variant(ref))


def test_default_run_config_matches():
    assert dataclasses.asdict(config.RunConfig()) \
        == dataclasses.asdict(jcfg.RunConfig())
    assert config.RunConfig().kv_cache_dtype == "bfloat16"


def test_registry_lists_ported_and_raises_for_others():
    """All ten of the reference's assigned archs are registered (the
    last three, codeqwen1.5-7b, minitron-4b and granite-34b, since they
    were ported); a name the reference does not register raises."""
    assert config.list_archs() == [
        "codeqwen1.5-7b", "deepseek-moe-16b", "granite-34b",
        "llama-3.2-vision-90b", "minitron-4b", "qwen3-moe-30b-a3b",
        "tinyllama-1.1b", "whisper-tiny", "xlstm-125m", "zamba2-2.7b"]
    with pytest.raises(KeyError, match="granite-8b"):
        config.get_config("granite-8b")


def test_token_quality_matches():
    mine, ref = TokenQuality(), JaxTokenQuality()
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    steps = [0, 1, 2, 7, 64, 300]
    assert [mine.fid(t) for t in steps] == [ref.fid(t) for t in steps]
    assert mine.mean_fid(steps) == ref.mean_fid(steps)
