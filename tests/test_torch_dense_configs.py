"""The last three dense configs of the reference in the port:
``codeqwen1.5-7b`` (MHA, qkv bias, RMSNorm), ``minitron-4b`` (GQA at
G = 3, layernorm, squared ReLU) and ``granite-34b`` (multi-query,
G = H, layernorm, tanh GELU).

  * the config copies are ``==`` to the reference's, and the registry
    holds all ten of the reference's ``ASSIGNED_ARCHS``;
  * every leaf of the reference's param tree converts
    (``params_from_numpy``) to the port's schema, with its shape;
  * each smoke variant against the reference on the same params: the
    prefill logits, three greedy decode steps' logits and their tokens.
    The reference runs with REPRO_FORCE_PALLAS=1 (its Pallas kernels in
    interpret mode, the kernels the port follows).  Both trees carry
    params drawn from one numpy seed in the reference's structure:
    normal(0, 0.05), norm scales 1 + normal(0, 0.1), and the qkv and
    layernorm biases, which the reference's init leaves at zero, drawn
    too, so that they are checked at all.  At the reference's init
    (wk's fan_in rule gives k a scale of sqrt(d/KV)) every softmax is
    one-hot, and one bf16 rounding of a cached k moved minitron's
    second decode step by 4.4% of the largest |logit|, the float32 one
    by 1.05e-4 of it, while the reference's own Pallas and jnp paths
    part by 1.3e-5.  Tolerances: 1e-4 of the largest |logit| with a
    float32 cache (float32 sums in another order over two layers); 2e-2
    of it with the default bfloat16 cache (a cached k or v may round to
    the neighbouring bf16 value);
  * a narrow multi-query config at granite's group size (H = 48 on one
    KV head, D = 32): every decode_attention call of the port's decode
    step against the reference's ``decode_attention_pallas`` in
    interpret mode on the same inputs, within 2e-5 (the reference's
    kernel tolerance), and the logits within 1e-4 of the largest.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.configs import ASSIGNED_ARCHS  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

ARCHS = ["codeqwen1.5-7b", "minitron-4b", "granite-34b"]
B, S, MAX_LEN, STEPS = 2, 16, 32, 3
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MQA48 = dict(num_heads=48, num_kv_heads=1, head_dim=32)
STD = 0.05


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches_reference(arch):
    mine, ref = config.get_config(arch), jcfg.get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert dataclasses.asdict(config.smoke_variant(mine)) \
        == dataclasses.asdict(jcfg.smoke_variant(ref))


def test_every_assigned_arch_is_registered():
    assert config.list_archs() == sorted(ASSIGNED_ARCHS)
    for name in ASSIGNED_ARCHS:
        assert config.get_config(name).name == name
    with pytest.raises(KeyError, match="gpt-2"):
        config.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_schema_counts(arch):
    """The schema's leaves at full width: the analytic count plus the
    norms it leaves out (2L+1 of d, doubled by a layernorm's bias) and
    the qkv biases."""
    cfg = config.get_config(arch)
    n = sum(int(np.prod(p.shape)) for p in _leaves(transformer.schema(cfg)))
    norms = (2 * cfg.num_layers + 1) * cfg.d_model
    if cfg.norm == "layernorm":
        norms *= 2
    bias = cfg.num_layers * (cfg.num_heads + 2 * cfg.num_kv_heads) \
        * cfg.resolved_head_dim if cfg.use_qkv_bias else 0
    assert n == cfg.param_count() + norms + bias


def _drawn(tree, seed):
    """A param tree of the reference's structure and shapes, as numpy:
    norm scales (ones at init) drawn as 1 + normal(0, 0.1), every other
    leaf, the biases the init leaves at zero included, normal(0,
    STD)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        a = np.asarray(a, np.float32)
        base = 1.0 if np.all(a == 1) else 0.0
        std = 0.1 if base else STD
        return (base + std * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map(draw, tree)


class _Model:
    def __init__(self, arch, **over):
        self.cfg = dataclasses.replace(
            config.smoke_variant(config.get_config(arch)), **over)
        self.jcfg = dataclasses.replace(
            jcfg.smoke_variant(jcfg.get_config(arch)), **over)
        self.init_tree = jax.tree_util.tree_map(
            np.asarray, jax_api.init_model(self.jcfg, jax.random.PRNGKey(0)))
        self.np_tree = _drawn(self.init_tree, 1)
        self.jp = jax.tree_util.tree_map(jnp.asarray, self.np_tree)
        self.params = params_from_numpy(transformer.schema(self.cfg),
                                        self.np_tree, "cpu")
        self.toks = np.random.default_rng(2).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)


_MODELS = {}


def _model(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        _MODELS[key] = _Model(arch, **over)
    return _MODELS[key]


def _jax_greedy(m, kv_dtype):
    """The reference's prefill and STEPS greedy decode steps (the first
    fed token is the prompt's last, as the serving engine feeds it),
    Pallas forced."""
    run = jcfg.RunConfig(kv_cache_dtype=kv_dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        pl, cache = jax_api.make_prefill_step(m.jcfg, run, MAX_LEN)(
            m.jp, jnp.asarray(m.toks))
        step = jax_api.make_decode_step(m.jcfg, run)
        tok, logits, toks = jnp.asarray(m.toks[:, -1:]), [], []
        for _ in range(STEPS):
            lg, cache = step(m.jp, tok, cache)
            logits.append(np.asarray(lg[:, -1], np.float32))
            tok = jnp.argmax(lg[:, -1], axis=-1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok[:, 0]))
    return np.asarray(pl, np.float32), logits, toks


def _port_greedy(m, kv_dtype):
    run = config.RunConfig(kv_cache_dtype=kv_dtype)
    pl, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(
        m.params, torch.tensor(m.toks, dtype=torch.int64))
    step = api.make_decode_step(m.cfg, run)
    tok, logits, toks = torch.tensor(m.toks[:, -1:], dtype=torch.int64), \
        [], []
    for _ in range(STEPS):
        lg, cache = step(m.params, tok, cache)
        logits.append(lg[:, -1].float().numpy())
        tok = lg[:, -1].argmax(-1)[:, None]
        toks.append(tok[:, 0].numpy())
    return pl.float().numpy(), logits, toks


def _close_scaled(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_tree_converts(arch):
    """Every leaf of the reference's smoke init, qkv biases and
    layernorm biases included, converts with the reference's shape."""
    m = _model(arch)
    params = params_from_numpy(transformer.schema(m.cfg), m.init_tree, "cpu")
    ref_leaves = jax.tree_util.tree_leaves_with_path(m.init_tree)
    assert len(ref_leaves) == len(list(_leaves(params)))
    for path, leaf in ref_leaves:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), leaf)
    attn = params["layers"]["attn"]
    assert ("bq" in attn) == m.cfg.use_qkv_bias
    assert ("bias" in params["layers"]["ln1"]) == \
        (m.cfg.norm == "layernorm")


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_and_greedy_decode_match_reference(arch, kv_dtype):
    m = _model(arch)
    jpl, jlogits, jtoks = _jax_greedy(m, kv_dtype)
    pl, logits, toks = _port_greedy(m, kv_dtype)
    assert pl.shape == (B, S, m.cfg.vocab_size)
    _close_scaled(pl, jpl, TOL[kv_dtype])
    for got, want in zip(logits, jlogits):
        _close_scaled(got, want, TOL[kv_dtype])
    for got, want in zip(toks, jtoks):
        np.testing.assert_array_equal(got, want)


def test_multi_query_at_granite_group_size_matches_pallas():
    """H = 48 query heads on one KV head (granite's G) at D = 32: every
    decode_attention call of the port's decode step (the wrapper takes
    G > 32; on the CPU its plain version) against the reference's Pallas
    kernel in interpret mode on the same inputs, within 2e-5; the
    logits within 1e-4 of the largest against the reference's decode."""
    m = _model("granite-34b", **MQA48)
    assert m.cfg.q_per_kv == 48
    run = config.RunConfig(kv_cache_dtype="float32")
    _, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(
        m.params, torch.tensor(m.toks, dtype=torch.int64))
    calls, real = [], dec_ops.decode_attention

    def spy(q, k, v, cur, **kw):
        out = real(q, k, v, cur, **kw)
        calls.append((q, k, v, cur, kw.get("window", 0), out))
        return out
    dec_ops.decode_attention = spy
    try:
        got, _ = api.make_decode_step(m.cfg, run)(
            m.params, torch.tensor(m.toks[:, -1:], dtype=torch.int64), cache)
    finally:
        dec_ops.decode_attention = real
    assert len(calls) == m.cfg.num_layers
    for q, k, v, cur, window, out in calls:
        assert q.shape == (B, 1, 48, 32) and k.shape == (B, MAX_LEN, 1, 32)
        want = decode_attention_pallas(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), jnp.asarray(cur.numpy()),
            window=window, bs=MAX_LEN, interpret=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5)
    jrun = jcfg.RunConfig(kv_cache_dtype="float32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        _, jcache = jax_api.make_prefill_step(m.jcfg, jrun, MAX_LEN)(
            m.jp, jnp.asarray(m.toks))
        want, _ = jax_api.make_decode_step(m.jcfg, jrun)(
            m.jp, jnp.asarray(m.toks[:, -1:]), jcache)
    _close_scaled(got.numpy(), np.asarray(want), 1e-4)
