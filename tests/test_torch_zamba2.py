"""The port's zamba2 (``repro_torch.models.zamba2``) against
``repro.models.zamba2`` on the same params (the reference's
``init_model``, carried across with ``params_from_numpy``) and tokens:
``forward`` logits, the ``prefill`` cache (k, v, the conv state in
bfloat16, the SSM state, pos) and ``decode_step`` logits with the conv
state back in float32, on zamba2's smoke variant (one group of 2 Mamba2
layers, 4 heads of 64) and a narrow variant with the full model's
attention head size (d_model 320 over 4 heads: D = 80) and two groups,
which covers group order and the weight sharing.  Then the serving
path: the engine's batch axes, a batch that mixes a bfloat16 and a
float32 conv state, and ``DecodeWorkload(arch="zamba2-2.7b")`` tokens
against the reference's.

The reference runs with REPRO_FORCE_PALLAS=1 (its Pallas kernels in
interpret mode: ssd_scan, flash and decode attention) where the port
follows its kernels; interpret mode is slow, so that is the D = 80
variant once per cache type and the workload once.  Both variants are
held to the reference's plain jnp path too.  Tolerances are those of
tests/test_torch_transformer.py:

  * float32 KV cache: 1e-4 (atol and rtol) for logits; cache entries
    1e-4 relative to the largest |entry|;
  * bfloat16 cache (and the bfloat16 conv state): 2e-2, a value may
    round to the neighbouring bf16 value;
  * against the reference's jnp decode path (p cast to the cache's type
    before the PV product) with a bfloat16 cache: 2e-2.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import DecodeWorkload as JaxWorkload  # noqa: E402
from repro.api import Provisioner as JaxProvisioner  # noqa: E402
from repro.config import RunConfig as JaxRun  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.core.delay_model import DelayModel as JaxDelay  # noqa: E402
from repro.core.service import make_scenario as jax_scenario  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.serving.engine import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.api import DecodeWorkload, Provisioner  # noqa: E402
from repro_torch.config import RunConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.service import make_scenario  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.models import api, zamba2  # noqa: E402
from repro_torch.models.params import map_schema, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "zamba2-2.7b"
VARIANTS = {"smoke": {}, "d80": dict(d_model=320, num_layers=4)}
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S, MAX_LEN = 2, 16, 32


def configs(variant):
    return (dataclasses.replace(smoke_variant(get_config(ARCH)),
                                **VARIANTS[variant]),
            dataclasses.replace(jax_smoke(jax_get_config(ARCH)),
                                **VARIANTS[variant]))


def _np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)
                      if getattr(a, "dtype", None) == jnp.bfloat16 else a)


def _close(got, want, tol, scaled=False):
    want = _np(want)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=tol)


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
            zamba2.schema(self.cfg),
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
    pl, cache = api.make_prefill_step(cfg, run, MAX_LEN)(params, t)
    dl, cache2 = api.make_decode_step(cfg, run)(params, t[:, -1:], cache)
    return pl, cache, dl, cache2


def _check_cache(cfg, cache, jcache, kv_dtype):
    G, E = cfg.num_layers // cfg.shared_attn_every, cfg.shared_attn_every
    for name in ("k", "v"):
        assert cache[name].shape[:2] == (G, B)
        _close(cache[name], jcache[name], TOL[kv_dtype], scaled=True)
    conv, ssm = cache["ssm"]["conv"], cache["ssm"]["ssm"]
    assert conv.dtype == torch.bfloat16 and conv.shape[:3] == (G, E, B)
    assert str(jcache["ssm"]["conv"].dtype) == "bfloat16"
    _close(conv, jcache["ssm"]["conv"], TOL["bfloat16"], scaled=True)
    assert ssm.dtype == torch.float32
    _close(ssm, jcache["ssm"]["ssm"], TOL["float32"], scaled=True)
    np.testing.assert_array_equal(cache["pos"].numpy(), [S] * B)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"],
                         ids=["d80-float32", "d80-bfloat16"])
def test_prefill_decode_match_reference_pallas(kv_dtype):
    m = _model("d80")
    assert m.cfg.resolved_head_dim == 80
    pl, cache, dl, cache2 = _port_run(m.cfg, m.params, m.toks, kv_dtype)
    jpl, jcache, jdl, jcache2 = m.ref(kv_dtype, True)
    _close(pl, jpl, 1e-4)
    _check_cache(m.cfg, cache, jcache, kv_dtype)
    _close(dl, jdl, TOL[kv_dtype])
    # after a decode step the conv state is in the activations' type
    assert cache2["ssm"]["conv"].dtype == torch.float32
    assert str(jcache2["ssm"]["conv"].dtype) == "float32"
    # (its first W-2 rows come from the bfloat16 prefill state)
    _close(cache2["ssm"]["conv"], jcache2["ssm"]["conv"], TOL["bfloat16"],
           scaled=True)
    _close(cache2["ssm"]["ssm"], jcache2["ssm"]["ssm"], 1e-4, scaled=True)
    np.testing.assert_array_equal(cache2["pos"].numpy(), [S + 1] * B)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_matches_reference_jnp_path(model, kv_dtype):
    cfg, params = model.cfg, model.params
    pl, cache, dl, cache2 = _port_run(cfg, params, model.toks, kv_dtype)
    jpl, jcache, jdl, jcache2 = model.ref(kv_dtype, False)
    _close(pl, jpl, 1e-4)
    _check_cache(cfg, cache, jcache, kv_dtype)
    _close(dl, jdl, TOL[kv_dtype])
    assert cache2["ssm"]["conv"].dtype == torch.float32


def test_forward_matches_reference(model):
    cfg, params = model.cfg, model.params
    t = torch.tensor(model.toks, dtype=torch.int64)
    logits, aux, kvs = zamba2.forward(cfg, params, t, RunConfig(),
                                      collect_kv=True)
    jlogits, _, jkvs = jax_api.get_model(model.jcfg).forward(
        model.jcfg, model.jp, jnp.asarray(model.toks), JaxRun(),
        collect_kv=True)
    assert aux == 0.0 and logits.shape == (B, S, cfg.vocab_size)
    _close(logits, jlogits, 1e-4)
    for got, want in zip(kvs, jkvs):
        _close(got, want, 1e-4, scaled=True)
    last, _, none = zamba2.forward(cfg, params, t, RunConfig(),
                                   last_only=True)
    assert none is None
    torch.testing.assert_close(last, logits[:, -1:], atol=1e-5, rtol=1e-5)


def test_prefill_launches_nothing_on_the_cpu(model):
    """The wrapper takes the plain version for CPU tensors: no launch."""
    n = ssd_ops.launches
    api.make_prefill_step(model.cfg, RunConfig(), MAX_LEN)(
        model.params, torch.tensor(model.toks, dtype=torch.int64))
    assert ssd_ops.launches == n


def test_decode_step_leaves_its_input_cache_as_it_was(model):
    cfg, params = model.cfg, model.params
    run = RunConfig()
    t = torch.tensor(model.toks, dtype=torch.int64)
    _, cache = api.make_prefill_step(cfg, run, MAX_LEN)(params, t)
    before = {k: v.clone() for k, v in cache.items() if k != "ssm"}
    ssm_before = {k: v.clone() for k, v in cache["ssm"].items()}
    api.make_decode_step(cfg, run)(params, t[:, -1:], cache)
    for k in before:
        assert torch.equal(cache[k], before[k])
    for k in ssm_before:
        assert torch.equal(cache["ssm"][k], ssm_before[k])


def test_schema_and_cache_shapes_at_full_width():
    """Full width on the meta device: the reference's abstract shapes,
    2,422,670,240 params, and the engine's batch axes per leaf."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    sch = jax.tree_util.tree_leaves(zamba2.schema(cfg),
                                    is_leaf=lambda p: hasattr(p, "shape"))
    assert sum(int(np.prod(p.shape)) for p in sch) == 2_422_670_240
    jshapes = jax.tree_util.tree_map(lambda a: a.shape,
                                     jax_api.abstract_model(jcfg))
    params = map_schema(lambda p, _: torch.empty(p.shape, device="meta"),
                        zamba2.schema(cfg))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) \
        == jshapes
    run = RunConfig()
    cache = zamba2.init_cache(cfg, 8, 512, run, device="meta")
    jcache = jax_api.get_model(jcfg).init_cache(jcfg, 8, 512, JaxRun(),
                                                abstract=True)
    assert jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype)
                                             .replace("torch.", "")),
                                  cache) == \
        jax.tree_util.tree_map(lambda s: (s.shape, str(s.dtype)), jcache)
    eng = ServingEngine(cfg, params, run, 512, device="meta")
    assert eng._batch_axes == {"pos": 0, "k": 1, "v": 1,
                               "ssm": {"conv": 2, "ssm": 2}}


def test_unported_knobs_raise():
    """remat "block" and "group" (each group recomputed in the backward,
    as the reference checkpoints each group) now run and give the
    prefill logits of "none" (``==``; tests/test_torch_training.py
    holds their gradients); ``fsdp`` runs and, on one device, places
    nothing and gives the same logits (``==``; sharded runs are held in
    tests/test_torch_multidevice_families.py); ``shard_kv_seq`` runs
    and, on one device, gives the same logits (``==``; sequence-split
    caches are held in tests/test_torch_kv_seq.py); the in-place decode,
    which used to
    raise, is held to the reference by
    test_inplace_decode_matches_reference."""
    cfg, _ = configs("smoke")
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    base, _ = api.make_prefill_step(cfg, RunConfig(), MAX_LEN)(params, toks)
    for remat in ("block", "group"):
        got, _ = api.make_prefill_step(cfg, RunConfig(remat=remat),
                                       MAX_LEN)(params, toks)
        assert torch.equal(got, base), remat
    got, _ = api.make_prefill_step(cfg, RunConfig(fsdp=True), MAX_LEN)(
        params, toks)
    assert torch.equal(got, base)
    got, _ = api.make_prefill_step(cfg, RunConfig(shard_kv_seq=True),
                                   MAX_LEN)(params, toks)
    assert torch.equal(got, base)
    # per-head (4-D) B/C, the xLSTM form, runs in plain torch; the
    # ssd_scan kernel's wrapper refuses it
    with pytest.raises(NotImplementedError, match="per-head"):
        ssd_ops.ssd_scan(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2),
                         torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                         torch.zeros(1, 2, 8, 8))


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_inplace_decode_matches_reference(kv_dtype):
    """decode_inplace_cache (the shared block attends over the cache as
    it was, the new token out of band, plain torch in both): prefill and
    one decode step against the reference's in-place branch, Pallas
    forced for its prefill; logits at the file's tolerances, the written
    caches too; no decode kernel launch, and the buffers passed in are
    the ones returned."""
    m = _model("smoke")
    knobs = dict(kv_cache_dtype=kv_dtype, decode_inplace_cache=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jrun = JaxRun(**knobs)
        _, jcache = jax_api.make_prefill_step(m.jcfg, jrun, MAX_LEN)(
            m.jp, jnp.asarray(m.toks))
        jdl, jcache2 = jax_api.make_decode_step(m.jcfg, jrun)(
            m.jp, jnp.asarray(m.toks[:, -1:]), jcache)
    run = RunConfig(**knobs)
    t = torch.tensor(m.toks, dtype=torch.int64)
    _, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(m.params, t)
    dl, cache2 = api.make_decode_step(m.cfg, run)(m.params, t[:, -1:], cache)
    assert cache2["k"] is cache["k"] and cache2["v"] is cache["v"]
    _close(dl, jdl, TOL[kv_dtype])
    for name in ("k", "v"):
        _close(cache2[name], jcache2[name], TOL[kv_dtype], scaled=True)


def test_engine_batch_mixing_conv_state_types_matches_reference():
    """Request 0 decodes alone (its conv state becomes float32), then
    with request 1, fresh from prefill (bfloat16): the engine's
    concatenation promotes, as jnp.concatenate does, and the tokens
    equal the reference engine's on the same batches."""
    m = _model("smoke")
    prompts = [np.arange(8, dtype=np.int32) + 3 * i for i in range(2)]
    batches = [[0], [0, 1], [1], [0, 1]]
    out = {}
    for name, eng in (
            ("ref", JaxEngine(m.jcfg, m.jp, JaxRun(), MAX_LEN,
                              delay=JaxDelay(a=0.002, b=0.02))),
            ("port", ServingEngine(m.cfg, m.params, RunConfig(), MAX_LEN,
                                   delay=DelayModel(a=0.002, b=0.02),
                                   device="cpu"))):
        ids = [eng.submit(p, 1.0) for p in prompts]
        for batch in batches:
            eng.step_batch([ids[i] for i in batch])
            if name == "port" and batch == [0]:
                assert eng.requests[ids[0]].cache["ssm"]["conv"].dtype \
                    == torch.float32
                eng._ensure_prefilled(ids)
                assert eng.requests[ids[1]].cache["ssm"]["conv"].dtype \
                    == torch.bfloat16
        out[name] = [list(eng.requests[i].generated) for i in ids]
    assert out["port"] == out["ref"]
    assert [len(t) for t in out["port"]] == [3, 3]


def test_decode_workload_tokens_match_reference():
    """Provisioner(workload=DecodeWorkload(arch="zamba2-2.7b")) against
    repro.api's, on the same scenario, params and prompts: the same
    allocation and plan, token-exact greedy tokens (default bfloat16
    cache; the reference's Pallas kernels in interpret mode)."""
    scn = dict(K=3, tau_min=0.8, tau_max=1.5, content_bits=1024.0, seed=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jwl = JaxWorkload(arch=ARCH)
        ref = JaxProvisioner(jax_scenario(**scn), workload=jwl,
                             scheduler="stacking",
                             allocator="inv_se").run(jax.random.PRNGKey(0))
    wl = DecodeWorkload(arch=ARCH, device="cpu")
    cfg = smoke_variant(get_config(ARCH))
    wl.params = params_from_numpy(
        zamba2.schema(cfg), jax.tree_util.tree_map(np.asarray, jwl.params),
        "cpu")
    got = Provisioner(make_scenario(**scn), workload=wl,
                      scheduler="stacking", allocator="inv_se",
                      device="cpu").run()
    assert wl.cfg.name == "zamba2-2.7b-smoke"
    np.testing.assert_array_equal(got.allocation, ref.allocation)
    assert got.plan.batches == ref.plan.batches
    assert got.mean_fid == ref.mean_fid
    assert sorted(got.content) == sorted(ref.content)
    for k, toks in ref.content.items():
        assert len(toks) == ref.plan.steps_completed[k] > 0
        assert got.content[k] == list(toks)


def test_int8_cache_matches_reference():
    """The int8 KV cache (a dict of q and scales per group) through
    prefill and one decode step, against the reference's jnp path."""
    m = _model("smoke")
    pl, cache, dl, _ = _port_run(m.cfg, m.params, m.toks, "int8")
    jpl, jcache, jdl, _ = _jax_run(m.jcfg, m.jp, m.toks, "int8", False)
    assert cache["k"]["q"].dtype == torch.int8
    # k differs in its last float32 bits: a value may round one step off
    dq = cache["k"]["q"].numpy().astype(int) - np.asarray(jcache["k"]["q"])
    assert np.abs(dq).max() <= 1
    _close(pl, jpl, 1e-4)
    _close(dl, jdl, TOL["bfloat16"])
