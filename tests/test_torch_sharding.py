"""The port's sharding layer against the reference's, with no processes:
``config.DEFAULT_RULES`` and ``sharding_rules_for``, every schema's
logical axes, and the partition specs of ``launch/shardings.py``
(params with fsdp off and on, optimizer state, caches, inputs) for
every arch, read as tuples and held ``==`` to the reference's
``PartitionSpec`` trees; ``to_shardings``' placements on hand-checked
specs; and the two dedup orders (weights: the first use of a mesh axis
wins, activations: the last)."""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.launch import shardings as jshd  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.params import P as JaxP  # noqa: E402
from repro_torch import config as tcfg  # noqa: E402
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    P, PS, constrain, map_schema, param_pspecs, rule_active, spec_of,
    use_rules)

ARCHS = [a for a in tcfg.list_archs() if a != "ddim-cifar10"]
MESHES = {"2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def as_tuples(tree):
    """dicts stay dicts, lists and tuples of specs become lists, specs
    (the reference's PartitionSpec or the port's PS) tuples."""
    if isinstance(tree, (PartitionSpec, PS)):
        return tuple(tree)
    if isinstance(tree, dict):
        return {k: as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [as_tuples(v) for v in tree]
    raise TypeError(type(tree))


def jax_schema_leaves(tree):
    return jax.tree_util.tree_map(lambda p: (p.shape, p.axes, p.init,
                                             p.scale), tree,
                                  is_leaf=lambda x: isinstance(x, JaxP))


def port_schema_leaves(tree):
    return map_schema(lambda p, _: (p.shape, p.axes, p.init, p.scale), tree)


def normalise(tree):
    if isinstance(tree, dict):
        return {k: normalise(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [normalise(v) for v in tree]
    return tree


def test_default_rules_equal():
    assert tcfg.DEFAULT_RULES == jcfg.DEFAULT_RULES
    assert {"DEFAULT_RULES", "sharding_rules_for"} <= set(tcfg.__all__)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kv_seq", [False, True])
def test_rules_equal_every_arch(mesh, kv_seq):
    sizes = MESHES[mesh]
    for arch in ARCHS:
        for smoke in (False, True):
            tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
            if smoke:
                tc, jc = tcfg.smoke_variant(tc), jcfg.smoke_variant(jc)
            got = tcfg.sharding_rules_for(
                tc, sizes, tcfg.RunConfig(shard_kv_seq=kv_seq))
            want = jcfg.sharding_rules_for(
                jc, sizes, jcfg.RunConfig(shard_kv_seq=kv_seq))
            assert got == want, (arch, smoke)


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_axes_equal(arch):
    """Shapes, logical axes, init and scale of every leaf, the stacked
    (L, ...) ones included, at full size and smoke size."""
    for smoke in (False, True):
        tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
        if smoke:
            tc, jc = tcfg.smoke_variant(tc), jcfg.smoke_variant(jc)
        got = port_schema_leaves(api.get_model(tc).schema(tc))
        want = jax_schema_leaves(japi.get_model(jc).schema(jc))
        assert normalise(got) == normalise(want)


def test_leaf_axes_checked():
    with pytest.raises(AssertionError):
        P((2, 3), ("embed",))
    assert P((2, 3), ("embed", None)).axes == ("embed", None)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal(arch, mesh):
    """model_param_pspecs (fsdp off and on), opt_state_pspecs,
    cache_pspecs (f32, bf16, int8) and input_pspecs for every shape."""
    sizes = MESHES[mesh]
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    rules = tcfg.sharding_rules_for(tc, sizes)
    jrules = jcfg.sharding_rules_for(jc, sizes)
    assert rules == jrules
    for fsdp in (False, True):
        assert as_tuples(shd.model_param_pspecs(tc, rules, fsdp)) == \
            as_tuples(jshd.model_param_pspecs(jc, jrules, fsdp))
        assert as_tuples(shd.opt_state_pspecs(tc, rules, fsdp)) == \
            as_tuples(jshd.opt_state_pspecs(jc, jrules, fsdp))
    for kvd in ("float32", "bfloat16", "int8"):
        run, jrun = (tcfg.RunConfig(kv_cache_dtype=kvd),
                     jcfg.RunConfig(kv_cache_dtype=kvd))
        assert as_tuples(shd.cache_pspecs(tc, run, rules)) == \
            as_tuples(jshd.cache_pspecs(jc, jrun, jrules))
        for name in tcfg.SHAPES:
            assert as_tuples(shd.input_pspecs(
                tc, tcfg.SHAPES[name], run, rules)) == as_tuples(
                jshd.input_pspecs(jc, jcfg.SHAPES[name], jrun, jrules))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_init_cache(arch):
    """cache_pspecs has every family's init_cache structure, one spec
    entry per dim of each buffer."""
    cfg = tcfg.smoke_variant(tcfg.get_config(arch))
    rules = tcfg.sharding_rules_for(cfg, MESHES["2x2"])
    for kvd in ("float32", "int8"):
        run = tcfg.RunConfig(kv_cache_dtype=kvd)
        cache = api.get_model(cfg).init_cache(cfg, 4, 8, run, device="meta")
        specs = shd.cache_pspecs(cfg, run, rules)

        def check(s, t):
            if isinstance(s, dict):
                assert set(s) == set(t)
                for k in s:
                    check(s[k], t[k])
            elif isinstance(s, PS):
                assert len(s) == t.dim()
            else:
                assert len(s) == len(t)
                for a, b in zip(s, t):
                    check(a, b)
        check(specs, cache)


def test_to_shardings_by_hand():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    got = shd.to_shardings(mesh, {
        "a": PS(("pod", "data"), None, "model"),
        "b": PS(),
        "c": [PS(None, "data"), PS("model", None, None)]})
    assert got["a"] == [Shard(0), Shard(0), Shard(2)]
    assert got["b"] == [Replicate()] * 3
    assert got["c"][0] == [Replicate(), Shard(1), Replicate()]
    assert got["c"][1] == [Replicate(), Replicate(), Shard(0)]
    host = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    # "pod" is not on the host mesh: only data shards the batch
    assert shd.to_shardings(host, PS(("pod", "data"), "model")) == \
        [Shard(0), Shard(1)]


def test_dedup_orders():
    rules = tcfg.sharding_rules_for(
        tcfg.smoke_variant(tcfg.get_config("deepseek-moe-16b")),
        MESHES["2x2"])
    # weights: the first use wins (expert parallelism over the mlp split)
    assert spec_of(("experts", "embed", "mlp"), rules, last_wins=False) == \
        ("model", None, None)
    # activations: the last use wins
    assert spec_of(("batch", "experts", None, "mlp"), rules) == \
        ("data", None, None, "model")
    assert spec_of(("batch", "seq", "vocab"), rules) == ("data", None, "model")
    cfg = tcfg.smoke_variant(tcfg.get_config("deepseek-moe-16b"))
    up = param_pspecs(api.get_model(cfg).schema(cfg), rules)
    assert tuple(up["layers"]["moe"]["up"]) == (None, "model", None, None)


def test_constrain_outside_a_mesh():
    x = torch.ones(2, 3)
    assert constrain(x, ("batch", "embed")) is x
    rules = {"batch": ("data",), "seq": None}
    with use_rules(rules):
        assert rule_active("batch") and not rule_active("seq")
        assert constrain(x, ("batch", "embed")) is x
    assert not rule_active("batch")


def test_model_pspecs_dataclass_rules():
    """The ``model`` mapping drops where the size does not divide it:
    granite's one KV head keeps ``heads`` sharded and ``kv_heads``
    replicated."""
    cfg = dataclasses.replace(
        tcfg.smoke_variant(tcfg.get_config("tinyllama-1.1b")),
        num_kv_heads=1)
    rules = tcfg.sharding_rules_for(cfg, MESHES["2x2"])
    assert rules["heads"] == ("model",) and rules["kv_heads"] is None
    specs = api.model_pspecs(cfg, rules)
    assert tuple(specs["layers"]["attn"]["wq"]) == (None, None, "model", None)
    assert tuple(specs["layers"]["attn"]["wk"]) == (None, None, None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_what_a_mesh_does_not_run_raises(arch):
    """Every family runs under installed rules, with ``fsdp``, with
    ``shard_kv_seq`` and, under rules, with ``decode_slice_reads``
    (``check_run`` passes); on one device ``fsdp`` and ``shard_kv_seq``
    place nothing and give the prefill logits of the default (``==``).
    What ``check_run`` still refuses is an unknown ``prefill_logits``.
    Sharded runs of every family are held in
    tests/test_torch_multidevice.py,
    tests/test_torch_multidevice_families.py and
    tests/test_torch_kv_seq.py."""
    from repro_torch.models import transformer
    cfg = tcfg.smoke_variant(tcfg.get_config(arch))
    rules = tcfg.sharding_rules_for(cfg, MESHES["2x2"])
    transformer.check_run(cfg, tcfg.RunConfig(shard_kv_seq=True))
    transformer.check_run(cfg, tcfg.RunConfig(fsdp=True))
    with pytest.raises(ValueError, match="prefill_logits"):
        transformer.check_run(cfg, tcfg.RunConfig(prefill_logits="first"))
    with use_rules(rules):
        transformer.check_run(cfg, tcfg.RunConfig())
        transformer.check_run(cfg, tcfg.RunConfig(fsdp=True))
        transformer.check_run(cfg, tcfg.RunConfig(shard_kv_seq=True))
        transformer.check_run(cfg, tcfg.RunConfig(
            decode_window=8, decode_slice_reads=True))
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    extras = api.extra_input_specs(cfg, 1, abstract=False, device="cpu")
    with torch.no_grad():
        want, _ = api.make_prefill_step(cfg, tcfg.RunConfig(), 8)(
            params, toks, extras)
        got, _ = api.make_prefill_step(cfg, tcfg.RunConfig(fsdp=True), 8)(
            params, toks, extras)
        split, _ = api.make_prefill_step(
            cfg, tcfg.RunConfig(shard_kv_seq=True), 8)(params, toks, extras)
    assert torch.equal(got, want) and torch.equal(split, want)
