"""The port's VLM family (``llama-3.2-vision-90b``: groups of self layers
and one tanh-gated cross-attention layer over the vision embeddings)
against ``repro.models.transformer``, and cross attention
(``layers.chunked_attention`` at Sq != Skv) against the reference's jnp
path.

Same params (the reference's ``init_model``, carried across with
``params_from_numpy``) with every cross layer's ``gate_attn`` and
``gate_mlp`` set from a numpy seed, uniform in [0.5, 1], in both trees:
the reference initialises them to zeros, and tanh(0) = 0 would leave the
cross layers out of the output.  The vision embeddings are drawn from
the seed too: the reference's stub (0.02 everywhere) makes every memory
row equal and every cross softmax uniform.  The reference runs with
REPRO_FORCE_PALLAS=1 (its Pallas kernels in interpret mode), which the
port's decode follows (p kept in float32).  Tolerances:

  * cross attention: 2e-5 in float32, 2e-2 in bfloat16 (the kernels');
  * logits: 1e-4 relative to the largest |logit| (atol) and 1e-4 rtol,
    on a float32 and on a bfloat16 KV cache; cache entries 1e-4 (f32)
    and 2e-2 (bf16) relative to the largest |entry|; greedy tokens
    equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.api import DecodeWorkload as JaxWorkload  # noqa: E402
from repro.config import RunConfig as JaxRun  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.configs.llama_3_2_vision_90b import CONFIG as JAX_VLM  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models.layers import chunked_attention as jax_chunked  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.api import DecodeWorkload  # noqa: E402
from repro_torch.config import RunConfig, smoke_variant  # noqa: E402
from repro_torch.configs.llama_3_2_vision_90b import CONFIG as VLM  # noqa: E402
from repro_torch.core.baselines import greedy_batching  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.service import ServiceRequest  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, layers, transformer  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine, TokenQuality  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, MAX_LEN, STEPS = 2, 16, 32, 3
LOGIT_TOL = 1e-4
CACHE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
ATTN = {"float32": (torch.float32, jnp.float32, 2e-5),
        "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, scaled=True):
    want = _np(want)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=tol)


# -- cross attention ----------------------------------------------------------

def _attn_inputs(Sq, Skv, H=8, KV=2, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Sq, H, D)).astype(np.float32),
            rng.standard_normal((2, Skv, KV, D)).astype(np.float32),
            rng.standard_normal((2, Skv, KV, D)).astype(np.float32))


@pytest.mark.parametrize("Sq,Skv", [(16, 40), (32, 16), (7, 100)],
                         ids=["Sq<Skv", "Sq>Skv", "Sq<Skv-ragged"])
@pytest.mark.parametrize("dtype", list(ATTN))
def test_cross_chunked_attention_matches_reference(Sq, Skv, dtype):
    """Not causal, no window, Sq != Skv: the port's chunked_attention
    (through the flash wrapper's plain version on the CPU) against the
    reference's jnp chunked path (its Pallas kernel takes Sq == Skv
    only)."""
    tdt, jdt, tol = ATTN[dtype]
    arrays = _attn_inputs(Sq, Skv)
    q, k, v = (torch.tensor(a).to(tdt) for a in arrays)
    before = fa_ops.launches
    got = layers.chunked_attention(q, k, v, causal=False)
    assert fa_ops.launches == before and got.shape == q.shape
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        want = jax_chunked(*(jnp.asarray(a, jdt) for a in arrays),
                           causal=False, q_chunk=8, kv_chunk=8)
    _close(got, want, tol, scaled=False)


def test_flash_wrapper_takes_sq_over_skv_only_unmasked():
    """Sq > Skv with ends aligned (no q_offset): the wrapper's plain
    version runs only without a mask; a causal or window mask would put
    the first query before the first key and is refused on every
    device.  With the query offset chunked_attention passes
    (continuation attention, starts aligned as in the reference's jnp
    path), Sq != Skv runs under either mask and equals the reference's
    jnp path within 2e-5."""
    arrays = _attn_inputs(32, 16, seed=1)
    q, k, v = (torch.tensor(a) for a in arrays)
    torch.testing.assert_close(
        fa_ops.flash_attention(q, k, v, causal=False),
        attention_ref(q, k, v, causal=False), atol=0, rtol=0)
    q2 = _attn_inputs(8, 16)[0]
    for kw in (dict(causal=True), dict(causal=False, window=8)):
        with pytest.raises(ValueError, match="Sq=32 > Skv=16"):
            fa_ops.flash_attention(q, k, v, **kw)
        for qa in (arrays[0], q2):
            got = layers.chunked_attention(torch.tensor(qa), k, v, **kw)
            with pytest.MonkeyPatch.context() as mp:
                mp.delenv("REPRO_FORCE_PALLAS", raising=False)
                want = jax_chunked(*(jnp.asarray(a) for a in
                                     (qa, arrays[1], arrays[2])),
                                   q_chunk=8, kv_chunk=8, **kw)
            _close(got, want, 2e-5, scaled=False)


# -- the model ----------------------------------------------------------------

def _set_gates(tree, rng):
    """The reference's param tree (numpy) with each cross layer's gates
    drawn uniform in [0.5, 1]."""
    cross = dict(tree["groups"]["cross"])
    for g in ("gate_attn", "gate_mlp"):
        cross[g] = rng.uniform(0.5, 1.0, cross[g].shape).astype(np.float32)
    return dict(tree, groups=dict(tree["groups"], cross=cross))


class _Model:
    def __init__(self, **over):
        self.cfg = dataclasses.replace(smoke_variant(VLM), **over)
        self.jcfg = dataclasses.replace(jax_smoke(JAX_VLM), **over)
        rng = np.random.default_rng(0)
        tree = _set_gates(jax.tree_util.tree_map(
            np.asarray, jax_api.init_model(self.jcfg,
                                           jax.random.PRNGKey(0))), rng)
        self.jp = jax.tree_util.tree_map(jnp.asarray, tree)
        self.params = params_from_numpy(transformer.schema(self.cfg), tree,
                                        "cpu")
        self.toks = rng.integers(0, self.cfg.vocab_size,
                                 (B, S)).astype(np.int32)
        self.vision = rng.standard_normal(
            (B, self.cfg.num_vision_tokens, self.cfg.d_model)).astype(
            np.float32)
        self._ref = {}

    def extras(self, rows=slice(None)):
        return {"vision_embeds": torch.tensor(self.vision[rows])}

    def jextras(self, rows=slice(None)):
        return {"vision_embeds": jnp.asarray(self.vision[rows])}

    def ref(self, kv_dtype):
        """The reference's prefill and STEPS greedy decode steps (the
        first re-feeds the prompt's last token, as the engine does)."""
        if kv_dtype not in self._ref:
            run = JaxRun(kv_cache_dtype=kv_dtype)
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_FORCE_PALLAS", "1")
                pl, cache = jax_api.make_prefill_step(self.jcfg, run,
                                                      MAX_LEN)(
                    self.jp, jnp.asarray(self.toks), self.jextras())
                step = jax_api.make_decode_step(self.jcfg, run)
                tok, out = jnp.asarray(self.toks[:, -1:]), []
                for _ in range(STEPS):
                    logits, c2 = step(self.jp, tok, out[-1][1] if out
                                      else cache, self.jextras())
                    out.append((logits, c2))
                    tok = jnp.argmax(logits[:, -1], -1)[:, None]
            self._ref[kv_dtype] = (pl, cache, out)
        return self._ref[kv_dtype]


_MODELS = {}


def _model():
    if "smoke" not in _MODELS:
        _MODELS["smoke"] = _Model()
    return _MODELS["smoke"]


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference_pallas(kv_dtype):
    """Prefill logits and cache (self and cross k/v), then STEPS greedy
    decode steps, each step's logits and self cache against the
    reference's; the same greedy tokens."""
    m = _model()
    jpl, jcache, jsteps = m.ref(kv_dtype)
    run = RunConfig(kv_cache_dtype=kv_dtype)
    t = torch.tensor(m.toks, dtype=torch.int64)
    pl, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(m.params, t,
                                                           m.extras())
    _close(pl, jpl, LOGIT_TOL)
    G = m.cfg.num_layers // m.cfg.cross_attn_every
    assert cache["k"].shape[:3] == (G, m.cfg.cross_attn_every - 1, B)
    assert cache["cross_k"].shape == (G, B, m.cfg.num_vision_tokens,
                                      m.cfg.num_kv_heads,
                                      m.cfg.resolved_head_dim)
    for name in ("k", "v", "cross_k", "cross_v"):
        assert cache[name].dtype == getattr(torch, kv_dtype)
        _close(cache[name], jcache[name], CACHE_TOL[kv_dtype])
    step = api.make_decode_step(m.cfg, run)
    tok = t[:, -1:]
    for jl, jc in jsteps:
        logits, cache = step(m.params, tok, cache, m.extras())
        _close(logits, jl, LOGIT_TOL)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        np.testing.assert_array_equal(
            tok.numpy(), np.asarray(jnp.argmax(jl[:, -1], -1))[:, None])
        for name in ("k", "v"):
            _close(cache[name], jc[name], CACHE_TOL[kv_dtype])
    np.testing.assert_array_equal(cache["pos"].numpy(), [S + STEPS] * B)


def test_forward_matches_reference_jnp_path():
    """forward's logits and its stacked ((k, v), (ck, cv)) against the
    reference's plain jnp path; last_only keeps the last position."""
    m = _model()
    t = torch.tensor(m.toks, dtype=torch.int64)
    logits, aux, ((k, v), (ck, cv)) = transformer.forward(
        m.cfg, m.params, t, RunConfig(), m.extras(), collect_kv=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("REPRO_FORCE_PALLAS", raising=False)
        jl, _, ((jk, jv), (jck, jcv)) = jax_api.get_model(m.jcfg).forward(
            m.jcfg, m.jp, jnp.asarray(m.toks), JaxRun(), m.jextras(),
            collect_kv=True)
    assert aux == 0.0
    _close(logits, jl, LOGIT_TOL)
    for got, want in ((k, jk), (v, jv), (ck, jck), (cv, jcv)):
        assert tuple(got.shape) == want.shape
        _close(got, want, 1e-4)
    last, _, none = transformer.forward(m.cfg, m.params, t, RunConfig(),
                                        m.extras(), last_only=True)
    assert none is None
    torch.testing.assert_close(last, logits[:, -1:], atol=1e-5, rtol=1e-5)


def test_gates_and_memory_reach_the_logits():
    """With the gates drawn, the vision embeddings move the logits; with
    the reference's zero gates they do not (tanh(0) = 0), which is why
    the parity tests draw the gates."""
    m = _model()
    t = torch.tensor(m.toks, dtype=torch.int64)
    other = {"vision_embeds": m.extras()["vision_embeds"] * 2 + 1}
    run = RunConfig()

    def logits(params, extras):
        return transformer.forward(m.cfg, params, t, run, extras)[0]
    assert float((logits(m.params, m.extras())
                  - logits(m.params, other)).abs().max()) > 1e-3
    cross = m.params["groups"]["cross"]
    shut = dict(m.params, groups=dict(m.params["groups"], cross=dict(
        cross, gate_attn=torch.zeros_like(cross["gate_attn"]),
        gate_mlp=torch.zeros_like(cross["gate_mlp"]))))
    assert torch.equal(logits(shut, m.extras()), logits(shut, other))


def test_engine_prefill_rows_equal_reference_batch1_prefill():
    """The engine keeps batch-1 extras and expands them to a prefill's
    rows: each row of its batch-2 prefill is the reference's batch-1
    prefill of that prompt against the same embeddings (which fails in
    the reference's own engine at batch 2)."""
    m = _model()
    eng = ServingEngine(m.cfg, m.params, RunConfig(kv_cache_dtype="float32"),
                        MAX_LEN, extras=m.extras(slice(0, 1)), device="cpu")
    logits, cache = eng.prefill(m.toks)
    assert eng.extras["vision_embeds"].shape[0] == 1
    run = JaxRun(kv_cache_dtype="float32")
    for i in range(B):
        jl, jc = jax_api.make_prefill_step(m.jcfg, run, MAX_LEN)(
            m.jp, jnp.asarray(m.toks[i:i + 1]), m.jextras(slice(0, 1)))
        _close(logits[i:i + 1], jl, LOGIT_TOL)
        _close(cache["cross_k"][:, i:i + 1], jc["cross_k"], 1e-4)
        _close(cache["k"][:, :, i:i + 1], jc["k"], 1e-4)


def _plan_matches(rep, delay):
    deadlines = rep["deadlines"]
    svcs = [ServiceRequest(id=i, deadline=d, spectral_eff=1.0)
            for i, d in enumerate(deadlines)]
    tp = {s.id: s.deadline for s in svcs}
    q = TokenQuality()
    plan = stacking(svcs, tp, delay, q)
    assert rep["steps"] == plan.steps_completed
    assert rep["quality_stacking"] == q.mean_fid(
        list(plan.steps_completed.values()))
    assert rep["quality_greedy"] == q.mean_fid(list(greedy_batching(
        svcs, tp, delay).steps_completed.values()))
    for rid, toks in rep["tokens"].items():
        assert len(toks) == plan.steps_completed[rid] > 0


def test_launcher_serves_the_smoke_vlm_on_the_cpu():
    """``launch.serve --arch llama-3.2-vision-90b --smoke --device cpu``
    with the reference's stub embeddings: its plan and penalties are the
    NumPy core's on its deadlines, every request gets its tokens; then
    once more with the calibration, which prefills batches 1, 2, 4
    against the batch-1 stub."""
    g = DelayModel(a=0.004, b=0.03)
    rep = serve.serve(["--arch", "llama-3.2-vision-90b", "--smoke",
                       "--device", "cpu", "--requests", "3"], delay=g,
                      echo=lambda _: None)
    assert rep["arch"] == "llama-3.2-vision-90b-smoke"
    _plan_matches(rep, g)
    rep = serve.serve(["--arch", "llama-3.2-vision-90b", "--smoke",
                       "--device", "cpu", "--deadlines", "0.05,0.1",
                       "--layers", "4"], echo=lambda _: None)
    assert sorted(rep["tokens"]) == [0, 1]
    assert all(len(rep["tokens"][k]) == rep["steps"][k] for k in (0, 1))


def test_config_copy_matches_reference():
    """The copy is the reference's field for field, registered, with the
    same analytic count.  That count adds an attention block per cross
    layer on top of L layers, where the schema's cross layers are among
    the L; the schema adds the norm scales (2L+1) and each cross layer's
    2 gates.  At 10 of its 100 layers (2 groups) the count is 10.96 B
    and the schema holds 10.66 B."""
    assert dataclasses.asdict(VLM) == dataclasses.asdict(JAX_VLM)
    assert config.get_config("llama-3.2-vision-90b") is VLM
    assert dataclasses.asdict(smoke_variant(VLM)) \
        == dataclasses.asdict(jax_smoke(JAX_VLM))
    d, hd = VLM.d_model, VLM.resolved_head_dim
    attn = 2 * d * VLM.num_heads * hd + 2 * d * VLM.num_kv_heads * hd
    sizes = {}
    for L in (100, 10):
        cfg = dataclasses.replace(VLM, num_layers=L)
        jcfg = dataclasses.replace(JAX_VLM, num_layers=L)
        n = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
            transformer.schema(cfg), is_leaf=lambda x: hasattr(x, "init")))
        assert cfg.param_count() == jcfg.param_count()
        G = L // cfg.cross_attn_every
        assert n == cfg.param_count() - G * attn + (2 * L + 1) * d + 2 * G
        sizes[L] = (cfg.param_count(), n)
    assert sizes[10] == (10_959_716_352, 10_657_898_500)


def test_schema_and_cache_shapes_at_full_width():
    """10 layers at full width on the meta device: the reference's
    abstract param and cache shapes, and the engine's batch axes."""
    cfg = dataclasses.replace(VLM, num_layers=10)
    jcfg = dataclasses.replace(JAX_VLM, num_layers=10)
    params = api.abstract_model(cfg)
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        params) == jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), jax_api.abstract_model(jcfg))
    cache = transformer.init_cache(cfg, 8, 512, RunConfig(), device="meta")
    jcache = jax_api.get_model(jcfg).init_cache(jcfg, 8, 512, JaxRun(),
                                                abstract=True)
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        cache) == jax.tree_util.tree_map(
        lambda s: (s.shape, str(s.dtype)), jcache)
    eng = ServingEngine(cfg, params, RunConfig(), 512, device="meta")
    assert eng._batch_axes == {"pos": 0, "k": 2, "v": 2, "cross_k": 1,
                               "cross_v": 1}


def test_extra_input_specs_are_the_reference_stubs():
    """The VLM's 0.02 vision embeddings and whisper's zero frames, value
    for value in bfloat16, on the device asked for (the meta device when
    abstract); None for a family without a front end."""
    from repro.configs.whisper_tiny import CONFIG as JAX_WHISPER
    from repro_torch.configs.whisper_tiny import CONFIG as WHISPER
    for mine, ref, key in ((smoke_variant(VLM), jax_smoke(JAX_VLM),
                            "vision_embeds"),
                           (smoke_variant(WHISPER), jax_smoke(JAX_WHISPER),
                            "audio_frames")):
        got = api.extra_input_specs(mine, 2, abstract=False, device="cpu")
        want = jax_api.extra_input_specs(ref, 2, abstract=False)
        assert list(got) == list(want) == [key]
        assert got[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
        meta = api.extra_input_specs(mine, 3)[key]
        assert meta.device.type == "meta"
        assert tuple(meta.shape) == jax_api.extra_input_specs(ref, 3)[
            key].shape
    tiny = smoke_variant(config.get_config("tinyllama-1.1b"))
    assert api.extra_input_specs(tiny, 2, abstract=False,
                                 device="cpu") is None


def test_decode_workload_refuses_the_vlm():
    """DecodeWorkload builds its engine without extras (as the
    reference's does, which then fails on the VLM): the port raises a
    NotImplementedError that names the family."""
    with pytest.raises(NotImplementedError, match="vlm"):
        DecodeWorkload(arch="llama-3.2-vision-90b", device="cpu")._eng()
    with pytest.raises(TypeError):
        JaxWorkload(arch="llama-3.2-vision-90b").calibrate(
            batch_sizes=(1,), reps=1)


def test_remat_and_gradients_raise():
    """The VLM trains now: under every ``remat`` the forward runs and
    gives the logits of "none" (``==``), and with params that need a
    gradient the loss's backward reaches every leaf
    (tests/test_torch_training.py holds its loss and grads to
    ``jax.value_and_grad``); the forward still runs under
    ``torch.no_grad``.  ``fsdp`` runs and, on one device, places
    nothing and gives the logits of the default (``==``; sharded runs
    are held in tests/test_torch_multidevice_families.py);
    ``shard_kv_seq`` runs too and, on one device, gives the default's
    logits (``==``; sequence-split caches are held in
    tests/test_torch_kv_seq.py)."""
    m = _model()
    t = torch.tensor(m.toks[:, :4], dtype=torch.int64)
    base, _, _ = transformer.forward(m.cfg, m.params, t, RunConfig(),
                                     m.extras())
    for remat in ("block", "group", "full"):
        got, _, _ = transformer.forward(m.cfg, m.params, t,
                                        RunConfig(remat=remat), m.extras())
        assert torch.equal(got, base), remat
    params = jax.tree_util.tree_map(lambda p: p.clone().requires_grad_(),
                                    m.params)
    for remat in ("none", "group"):
        loss, _ = api.make_train_step(m.cfg, RunConfig(remat=remat))(
            params, t, torch.roll(t, -1, 1), m.extras())
        loss.backward()
        for p in jax.tree_util.tree_leaves(params):
            assert p.grad is not None and float(p.grad.abs().max()) > 0
            p.grad = None
    with torch.no_grad():
        transformer.forward(m.cfg, params, t, RunConfig(), m.extras())
    # the in-place decode runs now (tests/test_torch_perf_variants.py
    # holds the VLM's to the reference)
    got, _, _ = transformer.forward(m.cfg, m.params, t, RunConfig(fsdp=True),
                                    m.extras())
    assert torch.equal(got, base)
    got, _, _ = transformer.forward(m.cfg, m.params, t,
                                    RunConfig(shard_kv_seq=True), m.extras())
    assert torch.equal(got, base)


def test_new_modules_import_without_jax():
    """This slice's modules (whisper, xLSTM, the VLM's transformer, the
    model API, the engine and the launcher, and the three configs)
    import with jax blocked, and no module of repro gets loaded."""
    code = r"""
import sys
sys.modules["jax"] = None
import repro_torch.models.whisper, repro_torch.models.xlstm
import repro_torch.models.xlstm_model, repro_torch.models.transformer
import repro_torch.models.api, repro_torch.serving.engine
import repro_torch.launch.serve
import repro_torch.configs.whisper_tiny, repro_torch.configs.xlstm_125m
import repro_torch.configs.llama_3_2_vision_90b
from repro_torch.config import list_archs
assert len(list_archs()) == 10, list_archs()
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
