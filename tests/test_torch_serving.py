"""The port's serving engine and ``llm_decode`` workload against
``repro.serving.engine`` and ``repro.api``: the same plan, the same
greedy tokens, on TinyLlama's smoke variant and a narrow variant with
the full model's head geometry (G=8, D=64), given the same params (the
reference's ``init_model`` through ``params_from_numpy``) and prompts.

The reference runs with REPRO_FORCE_PALLAS=1 (its Pallas kernels in
interpret mode): the kernels the port follows.  Interpret mode is slow,
so the engine is compared on the GQA variant, once per cache type; the
smoke variant's tokens are compared through the Provisioner, with the
default bfloat16 cache.  Plans, allocations and
mean quality are compared with ``==`` (the same NumPy planning core);
tokens with ``==``.  With the default bfloat16 cache the tokens are
equal too on these inputs; a flip there would be a near-tie of two
logits and shows as a top-2 margin in the failure message.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
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
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine, TokenQuality  # noqa: E402

VARIANTS = {"smoke": {}, "gqa": dict(num_heads=8, num_kv_heads=1,
                                     head_dim=64)}
DEADLINES = (0.1, 0.16, 0.25)
MAX_LEN = 48
SCN = dict(K=3, tau_min=0.8, tau_max=1.5, content_bits=1024.0, seed=4)


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (8, 8, 5)]


_MODELS = {}


def _model(variant):
    """(cfg, params, jcfg, jp) of one variant, made once per process."""
    if variant not in _MODELS:
        kw = VARIANTS[variant]
        cfg = dataclasses.replace(
            smoke_variant(get_config("tinyllama-1.1b")), **kw)
        jcfg = dataclasses.replace(
            jax_smoke(jax_get_config("tinyllama-1.1b")), **kw)
        jp = jax_api.init_model(jcfg, jax.random.PRNGKey(0))
        params = params_from_numpy(
            transformer.schema(cfg), jax.tree_util.tree_map(np.asarray, jp),
            "cpu")
        _MODELS[variant] = cfg, params, jcfg, jp
    return _MODELS[variant]


@pytest.fixture(params=list(VARIANTS))
def model(request):
    return _model(request.param)


def _serve(engine, prompts):
    ids = [engine.submit(p, d) for p, d in zip(prompts, DEADLINES)]
    plan = engine.plan()
    return ids, plan, engine.execute(plan)


def _margin(cfg, params, run, prompt, tokens, step):
    """Top-2 logit margin of the port at ``step`` of one request."""
    eng = ServingEngine(cfg, params, run, MAX_LEN, device="cpu")
    _, cache = eng.prefill(prompt[None])
    tok = torch.tensor([[int(prompt[-1])]])
    for t in tokens[:step]:
        _, cache = eng.decode(tok, cache)
        tok = torch.tensor([[t]])
    logits, _ = eng.decode(tok, cache)
    top = torch.topk(logits[0, -1], 2).values
    return float(top[0] - top[1])


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"],
                         ids=["gqa-float32", "gqa-bfloat16"])
def test_engine_plan_and_tokens_match_reference(kv_dtype):
    cfg, params, jcfg, jp = _model("gqa")
    prompts = _prompts(cfg.vocab_size)
    delay = dict(a=0.002, b=0.02)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        _, jplan, want = _serve(
            JaxEngine(jcfg, jp, JaxRun(kv_cache_dtype=kv_dtype), MAX_LEN,
                      delay=JaxDelay(**delay)), prompts)
    run = RunConfig(kv_cache_dtype=kv_dtype)
    eng = ServingEngine(cfg, params, run, MAX_LEN,
                        delay=DelayModel(**delay), device="cpu")
    ids, plan, got = _serve(eng, prompts)
    assert plan.batches == jplan.batches
    assert plan.steps_completed == jplan.steps_completed
    # equal-length prompts share one prefill; one decode call per batch
    assert eng.prefill_calls == 2 and eng.decode_calls == plan.num_batches
    for rid in ids:
        assert len(got[rid]) == plan.steps_completed[rid]
        if got[rid] != list(want[rid]):
            i = next(j for j, (a, b) in enumerate(zip(got[rid], want[rid]))
                     if a != b)
            pytest.fail(f"request {rid} differs at token {i}; port top-2 "
                        f"margin {_margin(cfg, params, run, prompts[rid], got[rid], i):.3g}")


def test_batched_decode_matches_sequential(model):
    """Batched execution gives the tokens of serving each request alone
    (the port of tests/test_serving_training.py's check)."""
    cfg, params, _, _ = model
    run = RunConfig(kv_cache_dtype="float32")
    delay = DelayModel(a=0.002, b=0.02)
    prompts = [np.arange(6, dtype=np.int32) + i for i in range(3)]
    eng = ServingEngine(cfg, params, run, 64, delay=delay, device="cpu")
    ids = [eng.submit(p, 0.2) for p in prompts]
    batched = eng.execute(eng.plan())
    for i, p in enumerate(prompts):
        solo = ServingEngine(cfg, params, run, 64, delay=delay, device="cpu")
        rid = solo.submit(p, 0.2)
        n = len(batched[ids[i]])
        plan = solo.plan()
        plan.steps_completed[rid] = n
        plan.batches = plan.batches[:n]
        assert solo.execute(plan)[rid][:n] == batched[ids[i]][:n]


def test_timed_execute_takes_one_reading_per_batch(model):
    cfg, params, _, _ = model
    eng = ServingEngine(cfg, params, RunConfig(), 32, device="cpu")
    for d in (0.05, 0.1):
        eng.submit(np.arange(4, dtype=np.int32), d)
    plan = eng.plan()
    eng.execute(plan, timed=True)
    assert [x for x, _ in eng.last_timings] == plan.batch_sizes()
    assert eng.decode_calls == plan.num_batches    # one call per reading
    assert all(s > 0 for _, s in eng.last_timings)


def test_session_runs_batches_and_guards_retarget(model):
    cfg, params, _, _ = model
    wl = DecodeWorkload(cfg=cfg, params=params, max_len=16, prompt_len=8,
                        device="cpu")
    eng = wl._eng()
    eng.delay = DelayModel(a=0.002, b=0.02)
    for k in (0, 1):
        eng.submit(np.arange(8, dtype=np.int32), 0.1)
    plan = eng.plan()
    sess = wl.open_session(plan)
    sess.run_batch([k for k, _ in plan.batches[0]])
    with pytest.raises(ValueError):
        sess.retarget({0: 0})                  # below tokens decoded
    with pytest.raises(ValueError):
        sess.retarget({0: 9})                  # past max_len
    sess.retarget({0: 8})
    assert all(len(v) == 1 for v in sess.finish().values())


def test_provisioner_matches_reference():
    """Provisioner(workload="llm_decode", allocator="inv_se") on the
    scenario of tests/test_api.py: allocation, plan, mean quality and
    tokens equal to repro.api.Provisioner's, with the same params and
    prompts."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jwl = JaxWorkload()
        ref = JaxProvisioner(jax_scenario(**SCN), workload=jwl,
                             scheduler="stacking",
                             allocator="inv_se").run(jax.random.PRNGKey(0))
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    wl = DecodeWorkload(
        cfg=cfg, params=params_from_numpy(
            transformer.schema(cfg),
            jax.tree_util.tree_map(np.asarray, jwl.params), "cpu"),
        device="cpu")
    got = Provisioner(make_scenario(**SCN), workload=wl,
                      scheduler="stacking", allocator="inv_se",
                      device="cpu").run()
    np.testing.assert_array_equal(got.allocation, ref.allocation)
    assert got.tau_prime == ref.tau_prime
    assert got.plan.batches == ref.plan.batches
    assert got.plan.start_times == ref.plan.start_times
    assert got.mean_fid == ref.mean_fid
    assert got.outage_rate == ref.outage_rate
    assert got.workload_name == "llm_decode"
    assert isinstance(got.quality, TokenQuality)
    assert sorted(got.content) == sorted(ref.content)
    for k, toks in ref.content.items():
        assert got.content[k] == list(toks)
        assert len(toks) == ref.plan.steps_completed[k]


def test_workload_prompts_match_reference():
    wl, jwl = DecodeWorkload(device="cpu", init_seed=3), JaxWorkload(
        init_seed=3)
    for k in range(4):
        np.testing.assert_array_equal(wl._prompt(k, 512), jwl._prompt(k, 512))


def test_workload_by_name_executes_on_cpu_and_rejects_latents():
    p = Provisioner(make_scenario(K=2, tau_min=0.3, tau_max=0.5,
                                  content_bits=1024.0, seed=1),
                    workload="llm_decode", allocator="inv_se", device="cpu")
    rep = p.run(timed=True)
    for k, toks in rep.content.items():
        assert len(toks) == rep.plan.steps_completed[k]
    assert [x for x, _ in rep.timings] == rep.plan.batch_sizes()
    with pytest.raises(ValueError, match="latents"):
        p.workload.execute(rep.plan, latents={0: np.zeros(3)})


def test_calibrate_fits_a_delay_model():
    wl = DecodeWorkload(max_len=40, device="cpu")
    curve = wl.measure_delay_curve(batch_sizes=(1, 2), reps=1)
    assert [x for x, _ in curve] == [1, 2] and all(s > 0 for _, s in curve)
    g = wl.calibrate(batch_sizes=(1, 2), reps=1)
    assert np.isfinite([g.a, g.b]).all() and wl._eng().delay is g


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DecodeWorkload()
    with pytest.raises(RuntimeError, match="cuda"):
        Provisioner(make_scenario(K=2), workload="llm_decode")
