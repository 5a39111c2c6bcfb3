"""The port's xLSTM (``repro_torch.models.xlstm`` and ``xlstm_model``:
alternating mLSTM and sLSTM blocks, tied embeddings) against
``repro.models.xlstm`` and ``repro.models.xlstm_model``, and the
per-head form of ``ssm.ssd_chunked`` (the mLSTM's scan) against the
reference's.

Same params (the reference's ``init_model``, carried across with
``params_from_numpy``) and inputs from a numpy seed.  The reference runs
with REPRO_FORCE_PALLAS=1 where the whole model is compared (xLSTM
reaches none of its Pallas kernels: the per-head scan is jnp there too,
and the blocks' norms are its jnp rmsnorm).  Tolerances:

  * the per-head scan and the blocks: 1e-5 relative to the largest
    |value| (float32 sums in another order);
  * logits: 1e-4 relative to the largest |logit| (atol) and 1e-4 rtol,
    with ``RunConfig`` on a float32 and on a bfloat16 KV cache (xLSTM
    keeps no KV cache: its states are float32 either way); the states
    1e-4 relative to their largest |entry|; greedy tokens equal.
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
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.configs.xlstm_125m import CONFIG as JAX_XLSTM  # noqa: E402
from repro.core.service import make_scenario as jax_scenario  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.models.ssm import ssd_chunked as jax_ssd_chunked  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.api import DecodeWorkload, Provisioner  # noqa: E402
from repro_torch.config import RunConfig, smoke_variant  # noqa: E402
from repro_torch.configs.xlstm_125m import CONFIG as XLSTM  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.service import make_scenario  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.core.service import ServiceRequest  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, ssm, xlstm, xlstm_model  # noqa: E402
from repro_torch.models.params import map_schema, params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServingEngine, TokenQuality  # noqa: E402

B, S, MAX_LEN, STEPS = 2, 16, 32, 3
LOGIT_TOL = 1e-4
BLOCK_TOL = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _close(got, want, tol, scaled=True):
    want = _np(want)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(_np(got), want, atol=atol, rtol=tol)


# -- the per-head SSD scan ----------------------------------------------

@pytest.mark.parametrize("Bt,St,H,Pd,N,chunk", [
    (2, 64, 2, 9, 8, 16),          # 4 chunks, P = N + 1 (the mLSTM's)
    (1, 48, 4, 33, 32, 48),        # one chunk
    (2, 32, 4, 129, 128, 128),     # the smoke mLSTM: Q = S
])
def test_per_head_ssd_chunked_matches_reference(Bt, St, H, Pd, N, chunk):
    """The per-head (B,S,H,N) B/C branch, in plain torch on every
    device, against the reference's jnp branch: y and the final state
    within 1e-5; no kernel launch."""
    rng = np.random.default_rng(Pd)
    x = rng.standard_normal((Bt, St, H, Pd)).astype(np.float32)
    a = (-0.2 * np.abs(rng.standard_normal((Bt, St, H)))).astype(np.float32)
    b = (0.3 * rng.standard_normal((Bt, St, H, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((Bt, St, H, N))).astype(np.float32)
    h0 = (0.1 * rng.standard_normal((Bt, H, Pd, N))).astype(np.float32)
    before = ssd_ops.launches
    y, h = ssm.ssd_chunked(*(torch.tensor(t) for t in (x, a, b, c, h0)),
                           chunk=chunk)
    assert ssd_ops.launches == before
    jy, jh = jax_ssd_chunked(*(jnp.asarray(t) for t in (x, a, b, c, h0)),
                             chunk=chunk)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    _close(y, jy, BLOCK_TOL)
    _close(h, jh, BLOCK_TOL)


def test_shared_form_still_goes_to_the_kernel_wrapper():
    """3-D B/C is the ssd_scan kernel's form: the wrapper (its plain
    version on the CPU) refuses per-head B/C."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((1, 16, 2, 8)), dtype=torch.float32)
    a = -torch.rand(1, 16, 2)
    b = torch.tensor(rng.standard_normal((1, 16, 4)), dtype=torch.float32)
    h0 = torch.zeros(1, 2, 8, 4)
    y, _ = ssm.ssd_chunked(x, a, b, b, h0)
    torch.testing.assert_close(y, ssd_ops.ssd_scan(x, a, b, b, h0)[0],
                               atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="per-head"):
        ssd_ops.ssd_scan(x, a, b[:, :, None].expand(1, 16, 2, 4)
                         .contiguous(), b, h0)


# -- the model ----------------------------------------------------------------

class _Model:
    def __init__(self):
        self.cfg, self.jcfg = smoke_variant(XLSTM), jax_smoke(JAX_XLSTM)
        self.jp = jax_api.init_model(self.jcfg, jax.random.PRNGKey(0))
        self.tree = jax.tree_util.tree_map(np.asarray, self.jp)
        self.params = params_from_numpy(xlstm_model.schema(self.cfg),
                                        self.tree, "cpu")
        rng = np.random.default_rng(0)
        self.toks = rng.integers(0, self.cfg.vocab_size,
                                 (B, S)).astype(np.int32)
        self.u = rng.standard_normal((B, S, self.cfg.d_model)).astype(
            np.float32)
        self._ref = {}

    def group(self, i=0):
        """Group i's params: (the port's, the reference's)."""
        return (jax.tree_util.tree_map(lambda t: t[i],
                                       self.params["groups"]),
                jax.tree_util.tree_map(lambda t: t[i], self.jp["groups"]))

    def ref(self):
        """The reference's prefill and STEPS greedy decode steps (the
        first re-feeds the prompt's last token, as the engine does)."""
        if not self._ref:
            run = JaxRun()
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("REPRO_FORCE_PALLAS", "1")
                pl, cache = jax_api.make_prefill_step(self.jcfg, run,
                                                      MAX_LEN)(
                    self.jp, jnp.asarray(self.toks))
                step = jax_api.make_decode_step(self.jcfg, run)
                tok, c, out = jnp.asarray(self.toks[:, -1:]), cache, []
                for _ in range(STEPS):
                    logits, c = step(self.jp, tok, c)
                    out.append((logits, c))
                    tok = jnp.argmax(logits[:, -1], -1)[:, None]
            self._ref.update(pl=pl, cache=cache, steps=out)
        return self._ref["pl"], self._ref["cache"], self._ref["steps"]


_MODELS = {}


def _model():
    if "smoke" not in _MODELS:
        _MODELS["smoke"] = _Model()
    return _MODELS["smoke"]


def _check_states(got, want, tol=1e-4):
    """The (mlstm, slstm) state trees: mem, conv and the 4 cell leaves."""
    for key in ("conv", "mem"):
        assert got["mlstm"][key].dtype == torch.float32
        _close(got["mlstm"][key], want["mlstm"][key], tol)
    assert isinstance(got["slstm"]["cell"], tuple)
    for g, w in zip(got["slstm"]["cell"], want["slstm"]["cell"]):
        _close(g, w, tol)


@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_blocks_match_reference(block):
    """Each block's forward (from zero state and continued from a state)
    and one step against the reference's, within 1e-5."""
    m = _model()
    lp, jlp = (g[block] for g in m.group())
    cfg, jcfg = m.cfg, m.jcfg
    fwd = getattr(xlstm, f"{block}_forward")
    jfwd = getattr(jax_xlstm, f"{block}_forward")
    step = getattr(xlstm, f"{block}_step")
    jstep = getattr(jax_xlstm, f"{block}_step")
    u, ju = torch.tensor(m.u), jnp.asarray(m.u)
    y, st = fwd(cfg, lp, u[:, :8])
    jy, jst = jfwd(jcfg, jlp, ju[:, :8])
    _close(y, jy, BLOCK_TOL)
    y, st = fwd(cfg, lp, u[:, 8:], st)
    jy, jst = jfwd(jcfg, jlp, ju[:, 8:], jst)
    _close(y, jy, BLOCK_TOL)
    y, st = step(cfg, lp, u[:, :1], st)
    jy, jst = jstep(jcfg, jlp, ju[:, :1], jst)
    _close(y, jy, BLOCK_TOL)
    for got, want in zip(jax.tree_util.tree_leaves(st),
                         jax.tree_util.tree_leaves(jst)):
        _close(got, want, BLOCK_TOL)


def test_forward_matches_reference():
    m = _model()
    t = torch.tensor(m.toks, dtype=torch.int64)
    logits, aux, (mst, sst) = xlstm_model.forward(
        m.cfg, m.params, t, RunConfig(), collect_kv=True)
    jl, _, (jm, js) = jax_api.get_model(m.jcfg).forward(
        m.jcfg, m.jp, jnp.asarray(m.toks), JaxRun(), collect_kv=True)
    assert aux == 0.0
    _close(logits, jl, LOGIT_TOL)
    _check_states({"mlstm": mst, "slstm": sst}, {"mlstm": jm, "slstm": js})
    last, _, none = xlstm_model.forward(m.cfg, m.params, t, RunConfig(),
                                        last_only=True)
    assert none is None
    torch.testing.assert_close(last, logits[:, -1:], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference_pallas(kv_dtype):
    """Prefill logits and states, then STEPS greedy decode steps, each
    step's logits and states against the reference's; the same
    tokens; the cache passed in is left as it was."""
    m = _model()
    jpl, jcache, jsteps = m.ref()
    run = RunConfig(kv_cache_dtype=kv_dtype)
    t = torch.tensor(m.toks, dtype=torch.int64)
    pl, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(m.params, t)
    _close(pl, jpl, LOGIT_TOL)
    _check_states(cache, jcache)
    np.testing.assert_array_equal(cache["pos"].numpy(), [S] * B)
    before = jax.tree_util.tree_map(lambda x: x.clone(), cache)
    step = api.make_decode_step(m.cfg, run)
    tok, c = t[:, -1:], cache
    for jl, jc in jsteps:
        logits, c = step(m.params, tok, c)
        _close(logits, jl, LOGIT_TOL)
        _check_states(c, jc)
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        np.testing.assert_array_equal(
            tok.numpy(), np.asarray(jnp.argmax(jl[:, -1], -1))[:, None])
    np.testing.assert_array_equal(c["pos"].numpy(), [S + STEPS] * B)
    for a, b in zip(jax.tree_util.tree_leaves(cache),
                    jax.tree_util.tree_leaves(before)):
        assert torch.equal(a, b)


def test_rmsnorm_launches_per_block_and_nothing_on_the_cpu():
    """One rmsnorm wrapper call per block per forward and per decode
    step (the inner norms; the pre-norms are layernorms), through the
    plain version on the CPU: no launch."""
    m = _model()
    calls = []
    real = rms_ops.rmsnorm

    def spy(x, w, eps=1e-6):
        calls.append(tuple(x.shape))
        return real(x, w, eps)
    launches = rms_ops.launches
    t = torch.tensor(m.toks, dtype=torch.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rms_ops, "rmsnorm", spy)
        _, cache = api.make_prefill_step(m.cfg, RunConfig(), MAX_LEN)(
            m.params, t)
        api.make_decode_step(m.cfg, RunConfig())(m.params, t[:, -1:], cache)
    d, d_in = m.cfg.d_model, m.cfg.ssm_expand * m.cfg.d_model
    G = m.cfg.num_layers // 2
    assert calls == [(B, S, d_in), (B, S, d)] * G + [(B, 1, d_in),
                                                      (B, 1, d)] * G
    assert rms_ops.launches == launches


def test_provisioner_serves_xlstm_like_reference():
    """Provisioner(workload=DecodeWorkload(arch="xlstm-125m")) on the
    smoke variant against repro.api's, same scenario, params and
    prompts: the same allocation and plan, greedy tokens equal.  The
    engine stacks and splits the sLSTM cell, a tuple, per request."""
    scn = dict(K=3, tau_min=0.8, tau_max=1.5, content_bits=1024.0, seed=4)
    m = _model()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jwl = JaxWorkload(arch="xlstm-125m", params=m.jp)
        ref = JaxProvisioner(jax_scenario(**scn), workload=jwl,
                             scheduler="stacking",
                             allocator="inv_se").run(jax.random.PRNGKey(0))
    wl = DecodeWorkload(arch="xlstm-125m", params=m.params, device="cpu")
    got = Provisioner(make_scenario(**scn), workload=wl,
                      scheduler="stacking", allocator="inv_se",
                      device="cpu").run()
    np.testing.assert_array_equal(got.allocation, ref.allocation)
    assert got.plan.batches == ref.plan.batches
    assert got.mean_fid == ref.mean_fid
    for k, toks in ref.content.items():
        assert len(toks) == ref.plan.steps_completed[k] > 0
        assert got.content[k] == list(toks)


def test_launcher_serves_the_smoke_model_on_the_cpu():
    """``launch.serve --arch xlstm-125m --smoke --device cpu``: the plan
    is the NumPy core's STACKING on its deadlines and every request gets
    its planned tokens."""
    g = DelayModel(a=0.004, b=0.03)
    rep = serve.serve(["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
                       "--requests", "3"], delay=g, echo=lambda _: None)
    svcs = [ServiceRequest(id=i, deadline=d, spectral_eff=1.0)
            for i, d in enumerate(rep["deadlines"])]
    plan = stacking(svcs, {s.id: s.deadline for s in svcs}, g,
                    TokenQuality())
    assert rep["arch"] == "xlstm-125m-smoke"
    assert rep["steps"] == plan.steps_completed
    for rid, toks in rep["tokens"].items():
        assert len(toks) == plan.steps_completed[rid] > 0


def test_config_copy_matches_reference():
    """The copy is the reference's field for field, registered, with the
    same analytic count (88.2 M) and the reference's schema leaf for leaf
    at full width, which holds 134.4 M: the count's formula is Mamba2's,
    not the xLSTM blocks' (the mLSTM's q, k and v projections and the
    sLSTM's gates and FFN are not in it)."""
    assert dataclasses.asdict(XLSTM) == dataclasses.asdict(JAX_XLSTM)
    assert config.get_config("xlstm-125m") is XLSTM
    assert dataclasses.asdict(smoke_variant(XLSTM)) \
        == dataclasses.asdict(jax_smoke(JAX_XLSTM))
    assert XLSTM.param_count() == JAX_XLSTM.param_count() == 88_215_552
    params = map_schema(lambda p, _: torch.empty(p.shape, device="meta"),
                        xlstm_model.schema(XLSTM))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == \
        jax.tree_util.tree_map(lambda a: a.shape,
                               jax_api.abstract_model(JAX_XLSTM))
    n = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
        xlstm_model.schema(XLSTM), is_leaf=lambda x: hasattr(x, "init")))
    assert n == 134_357_040


def test_cache_shapes_and_engine_axes_at_full_width():
    """The states at full width on the meta device: the reference's
    abstract cache (mem (G, B, 4, 385, 384) float32), and the engine's
    batch axis per leaf, the sLSTM cell a tuple."""
    cache = xlstm_model.init_cache(XLSTM, 8, 512, RunConfig(),
                                   device="meta")
    jcache = jax_api.get_model(JAX_XLSTM).init_cache(JAX_XLSTM, 8, 512,
                                                     JaxRun(), abstract=True)
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        cache) == jax.tree_util.tree_map(
        lambda s: (s.shape, str(s.dtype)), jcache)
    assert tuple(cache["mlstm"]["mem"].shape) == (6, 8, 4, 385, 384)
    params = map_schema(lambda p, _: torch.empty(p.shape, device="meta"),
                        xlstm_model.schema(XLSTM))
    eng = ServingEngine(XLSTM, params, RunConfig(), 512, device="meta")
    assert eng._batch_axes == {"pos": 0, "mlstm": {"conv": 1, "mem": 1},
                               "slstm": {"cell": (1, 1, 1, 1)}}


def test_model_api_maps_ssm_to_xlstm_and_raises_under_grad():
    """get_model maps the ssm family to xLSTM, which takes no extras and
    trains now: under ``remat`` "block" and "group" (each group
    recomputed) the forward gives the logits of "none" (``==``), and
    with params that need a gradient the loss's backward reaches every
    leaf (tests/test_torch_training.py holds its loss and grads to
    ``jax.value_and_grad``).  ``fsdp`` runs and, on one device, places
    nothing and gives the logits of the default (``==``; sharded runs
    are held in tests/test_torch_multidevice_families.py);
    ``shard_kv_seq`` runs and changes nothing (xLSTM has no KV cache, as
    in the reference): the logits of the default (``==``)."""
    m = _model()
    assert api.get_model(m.cfg) is xlstm_model
    assert api.extra_input_specs(m.cfg, 2, abstract=False,
                                 device="cpu") is None
    t = torch.tensor(m.toks[:, :4], dtype=torch.int64)
    base, _, _ = xlstm_model.forward(m.cfg, m.params, t, RunConfig())
    for remat in ("block", "group"):
        got, _, _ = xlstm_model.forward(m.cfg, m.params, t,
                                        RunConfig(remat=remat))
        assert torch.equal(got, base), remat
    params = jax.tree_util.tree_map(lambda p: p.clone().requires_grad_(),
                                    m.params)
    loss, _ = api.make_train_step(m.cfg, RunConfig(remat="group"))(
        params, t, torch.roll(t, -1, 1))
    loss.backward()
    for p in jax.tree_util.tree_leaves(params):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
    with torch.no_grad():
        got, _, _ = xlstm_model.forward(m.cfg, params, t,
                                        RunConfig(fsdp=True))
    assert torch.equal(got, base)
    with torch.no_grad():
        got, _, _ = xlstm_model.forward(m.cfg, params, t,
                                        RunConfig(shard_kv_seq=True))
    assert torch.equal(got, base)


# -- bfloat16 params ----------------------------------------------------------

BF16_TOL = 2e-2       # tests/test_kernels.py's bfloat16 tolerance, taken
                      # relative to the largest |logit|


def _bf16_params():
    """The reference's init in bfloat16, and the same values as the
    port's bfloat16 params (``params_from_numpy``)."""
    m = _model()
    jp = jax_api.init_model(m.jcfg, jax.random.PRNGKey(0), jnp.bfloat16)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return m, jp, params_from_numpy(xlstm_model.schema(m.cfg), tree, "cpu",
                                    dtype=torch.bfloat16)


def test_prefill_and_decode_on_bf16_params_match_reference():
    """Prefill and STEPS greedy decode steps on bfloat16 params (the dry
    run's type): the sLSTM's float32 carry meets the bfloat16 recurrent
    weights in float32, as jnp.einsum promotes.  Logits within BF16_TOL
    of the largest |logit|; each step is fed the reference's token, and
    the port's token equals it wherever the reference's top-2 margin
    exceeds that tolerance."""
    m, jp, params = _bf16_params()
    run, jrun = RunConfig(), JaxRun()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jl, jc = jax_api.make_prefill_step(m.jcfg, jrun, MAX_LEN)(
            jp, jnp.asarray(m.toks))
        jstep = jax_api.make_decode_step(m.jcfg, jrun)
        t = torch.tensor(m.toks, dtype=torch.int64)
        pl, c = api.make_prefill_step(m.cfg, run, MAX_LEN)(params, t)
        assert pl.dtype == torch.bfloat16
        _close(pl, jl, BF16_TOL, scaled=True)
        step = api.make_decode_step(m.cfg, run)
        jtok = jnp.asarray(m.toks[:, -1:])
        compared = 0
        for _ in range(STEPS):
            jl, jc = jstep(jp, jtok, jc)
            logits, c = step(params, torch.tensor(np.asarray(jtok),
                                                  dtype=torch.int64), c)
            want = _np(jl[:, -1])
            tol = BF16_TOL * float(np.abs(want).max())
            np.testing.assert_allclose(_np(logits[:, -1]), want, atol=tol)
            top2 = np.sort(want, axis=-1)[:, -2:]
            clear = top2[:, 1] - top2[:, 0] > tol
            got = _np(logits[:, -1]).argmax(-1)
            np.testing.assert_array_equal(got[clear],
                                          want.argmax(-1)[clear])
            compared += int(clear.sum())
            jtok = jnp.argmax(jl[:, -1], -1)[:, None]
    assert compared > 0
    assert all(np.isfinite(_np(x)).all()
               for x in jax.tree_util.tree_leaves(c) if x.is_floating_point())


def test_train_loss_on_bf16_params_is_finite_as_reference():
    """The training loss and its gradient on bfloat16 params: finite,
    the loss within BF16_TOL of the reference's (relative)."""
    m, jp, params = _bf16_params()
    labels = np.roll(m.toks, -1, axis=1)
    jloss, _ = jax_api.make_train_step(m.jcfg, JaxRun())(
        jp, jnp.asarray(m.toks), jnp.asarray(labels))
    for p in jax.tree_util.tree_leaves(params):
        p.requires_grad_(True)
    loss, nll = api.make_train_step(m.cfg, RunConfig())(
        params, torch.tensor(m.toks), torch.tensor(labels))
    loss.backward()
    assert np.isfinite(float(jloss)) and torch.isfinite(loss)
    assert abs(float(loss.detach()) - float(jloss)) \
        <= BF16_TOL * abs(float(jloss))
    assert all(torch.isfinite(p.grad).all()
               for p in jax.tree_util.tree_leaves(params))
