"""The port's dense transformer against ``repro.models.transformer`` on
the same params (the reference's ``init_model``, carried across with
``params_from_numpy``) and tokens: ``forward`` logits, the ``prefill``
cache and ``decode_step`` logits, on TinyLlama's smoke variant (4 heads,
4 KV heads) and a narrow variant with the full model's head geometry
(8 heads on 1 KV head, G=8, D=64), which the MHA smoke cannot check.

The reference runs with REPRO_FORCE_PALLAS=1 (its Pallas kernels in
interpret mode, read when it traces): the kernels the port follows,
with p kept in float32 in decode attention.  Interpret mode is slow, so
it runs on the GQA variant, once per cache type (float32, bfloat16);
both variants are held to the reference's plain jnp path.  The int8
cache's writes and reads are held to the reference in
tests/test_torch_kv_cache.py.  Tolerances:

  * float32 KV cache: 1e-4 (atol and rtol) for logits; for cache
    entries 1e-4 relative to the largest |entry| (k and v reach ~20 at
    the reference's init, where wk's fan_in is KV): float32 sums in
    another order over two layers;
  * default bfloat16 cache: 2e-2: a cached k or v may round to the
    neighbouring bf16 value;
  * against the reference's plain jnp path (p cast to the cache's type
    before the PV product): 2e-2, the bf16 tolerance.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import RunConfig as JaxRun  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.config import RunConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.models import api, layers, transformer  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

GQA = dict(num_heads=8, num_kv_heads=1, head_dim=64)
VARIANTS = {"smoke": {}, "gqa": GQA}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, MAX_LEN = 2, 16, 32


def configs(variant):
    return (dataclasses.replace(smoke_variant(get_config("tinyllama-1.1b")),
                                **VARIANTS[variant]),
            dataclasses.replace(jax_smoke(jax_get_config("tinyllama-1.1b")),
                                **VARIANTS[variant]))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)
                      if getattr(a, "dtype", None) == jnp.bfloat16 else a)


def _t(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else a


def _close(got, want, tol, scaled=False):
    want = _np(want)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(_t(got), want, atol=atol, rtol=tol)


def _jax_run(jcfg, jp, toks, kv_dtype, pallas):
    """Reference prefill and one decode step (the token after the prompt
    is its last one, as the serving engine feeds it)."""
    run = JaxRun(kv_cache_dtype=kv_dtype)
    with pytest.MonkeyPatch.context() as mp:
        if pallas:
            mp.setenv("REPRO_FORCE_PALLAS", "1")
        else:
            mp.delenv("REPRO_FORCE_PALLAS", raising=False)
        pl, cache = jax_api.make_prefill_step(jcfg, run, MAX_LEN)(
            jp, jnp.asarray(toks))
        dl, cache2 = jax_api.make_decode_step(jcfg, run)(
            jp, jnp.asarray(toks[:, -1:]), cache)
    return pl, cache, dl, cache2


class _Model:
    """One variant's configs, params and tokens; the reference's runs
    are made when a test first asks for them."""

    def __init__(self, variant):
        self.cfg, self.jcfg = configs(variant)
        self.jp = jax_api.init_model(self.jcfg, jax.random.PRNGKey(0))
        self.params = params_from_numpy(
            transformer.schema(self.cfg),
            jax.tree_util.tree_map(np.asarray, self.jp), "cpu")
        self.toks = np.random.default_rng(1).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)
        self._ref = {}

    def ref(self, kv_dtype, pallas):
        key = (kv_dtype, pallas)
        if key not in self._ref:
            self._ref[key] = _jax_run(self.jcfg, self.jp, self.toks,
                                      kv_dtype, pallas)
        return self._ref[key]

    def forward(self):
        """The reference's forward logits, Pallas forced."""
        if "forward" not in self._ref:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_FORCE_PALLAS", "1")
                self._ref["forward"] = jax_api.get_model(self.jcfg).forward(
                    self.jcfg, self.jp, jnp.asarray(self.toks), JaxRun())[0]
        return self._ref["forward"]


_MODELS = {}


def _model(variant):
    if variant not in _MODELS:
        _MODELS[variant] = _Model(variant)
    return _MODELS[variant]


@pytest.fixture(params=list(VARIANTS))
def model(request):
    return _model(request.param)


def _port_run(cfg, params, toks, kv_dtype):
    run = RunConfig(kv_cache_dtype=kv_dtype)
    t = torch.tensor(toks, dtype=torch.int64)
    logits, aux, _ = transformer.forward(cfg, params, t, run)
    pl, cache = api.make_prefill_step(cfg, run, MAX_LEN)(params, t)
    dl, cache2 = api.make_decode_step(cfg, run)(params, t[:, -1:], cache)
    return logits, pl, cache, dl, cache2


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"],
                         ids=["gqa-float32", "gqa-bfloat16"])
def test_forward_prefill_decode_match_reference_pallas(kv_dtype):
    m = _model("gqa")
    cfg = m.cfg
    logits, pl, cache, dl, cache2 = _port_run(cfg, m.params, m.toks,
                                              kv_dtype)
    jpl, jcache, jdl, jcache2 = m.ref(kv_dtype, True)
    assert logits.shape == (B, S, cfg.vocab_size)
    _close(logits, m.forward(), 1e-4)
    _close(pl, jpl, 1e-4)
    for name in ("k", "v"):
        _close(cache[name], jcache[name], TOL[kv_dtype], scaled=True)
    np.testing.assert_array_equal(cache2["pos"].numpy(), [S + 1] * B)
    np.testing.assert_array_equal(np.asarray(jcache2["pos"]), [S + 1] * B)
    _close(dl, jdl, TOL[kv_dtype])


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_decode_matches_reference_jnp_path(model, kv_dtype):
    _, pl, _, dl, _ = _port_run(model.cfg, model.params, model.toks,
                                kv_dtype)
    jpl, _, jdl, _ = model.ref(kv_dtype, False)
    _close(pl, jpl, 2e-2)
    _close(dl, jdl, 2e-2)


def test_decode_step_leaves_its_input_cache_as_it_was(model):
    cfg, params, toks = model.cfg, model.params, model.toks
    run = RunConfig()
    t = torch.tensor(toks, dtype=torch.int64)
    _, cache = api.make_prefill_step(cfg, run, MAX_LEN)(params, t)
    before = {k: v.clone() for k, v in cache.items()}
    n = dec_ops.launches
    api.make_decode_step(cfg, run)(params, t[:, -1:], cache)
    assert dec_ops.launches == n               # CPU: plain versions
    for k in before:
        assert torch.equal(cache[k], before[k])


def test_prefill_logits_last_only(model):
    run = RunConfig(prefill_logits="last")
    pl, _ = api.make_prefill_step(model.cfg, run, MAX_LEN)(
        model.params, torch.tensor(model.toks, dtype=torch.int64))
    assert pl.shape == (B, 1, model.cfg.vocab_size)
    # prefill runs no decode attention: the jnp path's logits hold 1e-4
    _close(pl, model.ref("float32", False)[0][:, -1:], 1e-4)


@pytest.mark.parametrize("knob,value", [
    ("remat", "block"), ("fsdp", True), ("shard_kv_seq", True)])
def test_unported_run_knobs_raise(knob, value):
    """Every knob of the list runs now.  remat is ported in every
    family: the hybrid family, which raised for it, gives the prefill
    logits of "none" (``==``; its gradients are held in
    tests/test_torch_training.py).  ``fsdp`` and ``shard_kv_seq`` are
    ported: outside a mesh they place nothing, as in the reference, and
    give the logits of the default (``==``; sharded runs are held in
    tests/test_torch_multidevice.py and tests/test_torch_kv_seq.py)."""
    cfg, _ = configs("smoke")
    if knob == "remat":
        cfg = smoke_variant(get_config("zamba2-2.7b"))
    run = RunConfig(**{knob: value})
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    got, _ = api.make_prefill_step(cfg, run, MAX_LEN)(params, toks)
    want, _ = api.make_prefill_step(cfg, RunConfig(), MAX_LEN)(params, toks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("knobs", [
    dict(decode_inplace_cache=True),
    dict(decode_window=8, decode_slice_reads=True),
    dict(decode_inplace_cache=True, decode_uniform_pos=True),
    dict(prefill_parallel_q=True)],
    ids=["decode_inplace_cache", "decode_slice_reads",
         "decode_uniform_pos", "prefill_parallel_q"])
def test_ported_run_knobs_match_reference(knobs):
    """The four serving knobs that used to raise: prefill and one decode
    step of the GQA variant (G = 8) against the reference run with the
    same knob, float32 cache, the reference's Pallas kernels in
    interpret mode (1e-4; tests/test_torch_perf_variants.py holds them
    over three steps, three cache types and rows at different
    positions)."""
    m = _model("gqa")
    jrun, run = JaxRun(kv_cache_dtype="float32", **knobs), \
        RunConfig(kv_cache_dtype="float32", **knobs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jpl, jcache = jax_api.make_prefill_step(m.jcfg, jrun, MAX_LEN)(
            m.jp, jnp.asarray(m.toks))
        jdl, jcache2 = jax_api.make_decode_step(m.jcfg, jrun)(
            m.jp, jnp.asarray(m.toks[:, -1:]), jcache)
    t = torch.tensor(m.toks, dtype=torch.int64)
    pl, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(m.params, t)
    dl, cache2 = api.make_decode_step(m.cfg, run)(m.params, t[:, -1:], cache)
    _close(pl, jpl, 1e-4)
    _close(dl, jdl, 1e-4)
    for name in ("k", "v"):
        _close(cache2[name], jcache2[name], 1e-4, scaled=True)


def test_other_families_raise():
    """Every family of the reference maps to a model (the audio, ssm and
    vlm ones since they were ported); an unknown family raises as in
    the reference (``check_run`` too), while ``fsdp`` and the serving
    knobs now run on a cross-attention config (the VLM's in-place decode
    is held to the reference in tests/test_torch_perf_variants.py, its
    sharded runs in tests/test_torch_multidevice_families.py)."""
    cfg, _ = configs("smoke")
    with pytest.raises(ValueError, match="unknown family"):
        api.get_model(dataclasses.replace(cfg, family="diffusion"))
    assert api.get_model(dataclasses.replace(cfg, family="vlm")) \
        is transformer
    vlm = dataclasses.replace(cfg, family="vlm", cross_attn_every=2)
    transformer.check_run(vlm, RunConfig())
    transformer.check_run(vlm, RunConfig(decode_inplace_cache=True,
                                         decode_uniform_pos=True))
    transformer.check_run(vlm, RunConfig(fsdp=True))
    with pytest.raises(ValueError, match="unknown family"):
        transformer.check_run(dataclasses.replace(cfg, family="diffusion"),
                              RunConfig())


def test_init_model_follows_the_reference_scales():
    """Leaf shapes, ones for norm scales, std 0.02 for the embedding and
    1/sqrt(shape[-2]) elsewhere (wq (L,d,H,hd): 1/sqrt(H))."""
    cfg, jcfg = configs("gqa")
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax_api.init_model(jcfg, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_leaves_with_path(jp)
    for path, leaf in flat:
        node = params
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.float32
        assert np.std(np.asarray(leaf)) == pytest.approx(
            float(node.std()), rel=0.1, abs=1e-6)


@pytest.mark.parametrize("positions", [np.arange(12, dtype=np.float32)[None],
                                       np.array([[3.0], [40.0]], np.float32)])
def test_apply_rope_matches_reference(positions):
    """Split-half rotary embedding, prefill (1, S) and decode (B, 1)
    positions, with and without precomputed tables."""
    x = np.random.default_rng(2).standard_normal(
        (2, positions.shape[1], 4, 64)).astype(np.float32)
    want = jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(positions),
                                 10000.0)
    pos = torch.tensor(positions)
    for tab in (None, layers.rope_tables(pos, 64, 10000.0)):
        _close(layers.apply_rope(torch.tensor(x), pos, 10000.0, tab), want,
               1e-5)


@pytest.mark.parametrize("activation", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("gated", [True, False])
def test_apply_mlp_matches_reference(activation, gated):
    cfg = dataclasses.replace(configs("smoke")[0], activation=activation,
                              gated_mlp=gated)
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) / 16
         for k, s in layers.mlp_schema(cfg).items()}
    x = rng.standard_normal((2, 3, cfg.d_model)).astype(np.float32)
    want = jax_layers.apply_mlp(cfg, {k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x))
    got = layers.apply_mlp(cfg, {k: torch.tensor(v) for k, v in p.items()},
                           torch.tensor(x))
    _close(got, want, 1e-4)


def test_layernorm_matches_reference():
    rng = np.random.default_rng(5)
    x, s, b = (rng.standard_normal(n).astype(np.float32)
               for n in ((3, 5, 96), 96, 96))
    cfg = dataclasses.replace(configs("smoke")[0], norm="layernorm")
    got = layers.apply_norm(cfg, {"scale": torch.tensor(s),
                                  "bias": torch.tensor(b)}, torch.tensor(x))
    want = jax_layers.apply_norm(cfg, {"scale": jnp.asarray(s),
                                       "bias": jnp.asarray(b)},
                                 jnp.asarray(x))
    _close(got, want, 2e-5)
