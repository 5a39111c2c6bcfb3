"""The port's MoE family against ``repro.models.moe`` and
``repro.models.transformer``: routing, the MoE layer, the smoke
variants' forward, prefill and decode, ``remat="block"``, serving
through the ``Provisioner``, and the config copies.

Same params (the reference's ``init_model``, carried across with
``params_from_numpy``) and inputs made from a numpy seed.  The
reference's dispatch tables are internal to its ``apply_moe``; the test
reads them by putting a code in place of its expert outputs (slot
e*C + c writes a one in column e*C + c), so that the combined output
holds each slot's gate at its token's row.  Tolerances:

  * routing: ``disp_tok`` ``==``; gates and aux within 1e-6 (float32
    softmax, one sum of K gates in another order);
  * the MoE layer: 1e-5 (float32 products in another order);
  * logits: 1e-4 relative to the largest |logit| (atol) and 1e-4 rtol.
    At the reference's init attention adds large values to the residual
    stream (wo's fan_in is the head dim), so float32 sums in another
    order move every logit by an amount that scales with the largest;
    aux within 1e-5 relative.
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
from repro.api import Provisioner as JaxProvisioner  # noqa: E402
from repro.config import RunConfig as JaxRun  # noqa: E402
from repro.config import get_config as jax_get_config  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.configs.deepseek_moe_16b import CONFIG as JAX_DEEPSEEK  # noqa: E402
from repro.configs.qwen3_moe_30b_a3b import CONFIG as JAX_QWEN3  # noqa: E402
from repro.core.service import make_scenario as jax_scenario  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.api import DecodeWorkload, Provisioner  # noqa: E402
from repro_torch.config import RunConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK  # noqa: E402
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3  # noqa: E402
from repro_torch.core.service import make_scenario  # noqa: E402
from repro_torch.models import api, moe, transformer  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
B, S, MAX_LEN = 2, 16, 32
ROOT = Path(__file__).resolve().parents[1]


def _close(got, want, tol, scaled=False):
    want = np.asarray(want, np.float32)
    atol = tol * float(np.abs(want).max()) if scaled else tol
    np.testing.assert_allclose(np.asarray(got.detach().float()), want,
                               atol=atol, rtol=tol)


class _Model:
    """One arch's smoke configs, the reference's params and the port's
    copy of them, and tokens."""

    def __init__(self, arch):
        self.cfg = smoke_variant(get_config(arch))
        self.jcfg = jax_smoke(jax_get_config(arch))
        self.jp = jax_api.init_model(self.jcfg, jax.random.PRNGKey(0))
        self.params = params_from_numpy(
            transformer.schema(self.cfg),
            jax.tree_util.tree_map(np.asarray, self.jp), "cpu")
        self.toks = np.random.default_rng(1).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)

    def layer_moe(self, i=0):
        """Layer i's MoE params: (reference's jnp, port's torch)."""
        return ({k: v[i] for k, v in self.jp["layers"]["moe"].items()},
                {k: v[i] for k, v in self.params["layers"]["moe"].items()})


_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        _MODELS[arch] = _Model(arch)
    return _MODELS[arch]


@pytest.fixture(params=ARCHS)
def model(request):
    return _model(request.param)


def _jax_dispatch(jcfg, jp_moe, x, cf, monkeypatch):
    """The reference's (disp_tok, disp_gate, aux) for x, read through
    its output: the expert outputs are replaced by one-hot codes of
    their slots (the second ``constrain`` of a (B, E, C, d) buffer), and
    shared experts are off, so out[b, s, e*C + c] is slot (e, c)'s gate
    where it holds token s.  Needs d >= E*C."""
    jcfg = dataclasses.replace(jcfg, num_shared_experts=0)
    seen = []

    def spy(t, axes):
        if axes == ("batch", "experts", None, "embed"):
            seen.append(t)
            if len(seen) == 2:
                Bt, E, C, d = t.shape
                assert d >= E * C
                code = jnp.eye(E * C, d, dtype=t.dtype).reshape(E, C, d)
                return jnp.broadcast_to(code, t.shape)
        return t
    monkeypatch.setattr(jax_moe, "constrain", spy)
    out, aux = jax_moe.apply_moe(jcfg, jp_moe, jnp.asarray(x),
                                 capacity_factor=cf)
    monkeypatch.undo()
    Bt, Sx, _ = x.shape
    E = jcfg.num_experts
    C = jax_moe.moe_capacity(jcfg, Sx, cf)
    codes = np.asarray(out)[..., :E * C].reshape(Bt, Sx, E, C)
    hit = codes != 0
    assert (hit.sum(axis=1) <= 1).all()       # a slot holds one token
    tok = np.where(hit.any(axis=1), hit.argmax(axis=1), Sx)
    gate = codes.sum(axis=1)
    return tok, gate, float(aux)


@pytest.mark.parametrize("seq", [1, S])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_matches_reference(model, cf, seq, monkeypatch):
    """Routing of random hidden states with the reference's router, at
    the default capacity factor and at 0.5, where choices are dropped;
    at prefill (S=16) and decode (S=1) lengths."""
    jm, pm = model.layer_moe()
    x = np.random.default_rng(2).standard_normal(
        (B, seq, model.cfg.d_model)).astype(np.float32)
    tok, gate, aux = moe.route(model.cfg, torch.tensor(x), pm["router"],
                               capacity_factor=cf)
    jtok, jgate, jaux = _jax_dispatch(model.jcfg, jm, x, cf, monkeypatch)
    C = moe.moe_capacity(model.cfg, seq, cf)
    assert C == jax_moe.moe_capacity(model.jcfg, seq, cf)
    assert tok.shape == gate.shape == (B, model.cfg.num_experts, C)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_allclose(gate.numpy(), jgate, atol=1e-6, rtol=0)
    assert float(aux) == pytest.approx(jaux, rel=1e-6, abs=1e-9)
    kept, choices = int((tok < seq).sum()), B * seq * \
        model.cfg.experts_per_token
    if seq == 1:
        assert kept == choices          # C = 1, K distinct experts
    elif cf == 0.5:
        assert kept < choices           # drops


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_route_ties_go_to_the_lower_expert(model, cf, monkeypatch):
    """A zero router ties every expert: each token takes experts 0..K-1
    (jax.lax.top_k's order), the earlier tokens fill their C slots, and
    the reference agrees."""
    jm, pm = model.layer_moe()
    jm = dict(jm, router=jnp.zeros_like(jm["router"]))
    x = np.random.default_rng(3).standard_normal(
        (B, S, model.cfg.d_model)).astype(np.float32)
    tok, gate, _ = moe.route(model.cfg, torch.tensor(x),
                             torch.zeros_like(pm["router"]),
                             capacity_factor=cf)
    jtok, jgate, _ = _jax_dispatch(model.jcfg, jm, x, cf, monkeypatch)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_allclose(gate.numpy(), jgate, atol=1e-6, rtol=0)
    K, C = model.cfg.experts_per_token, tok.shape[-1]
    want = np.full(tok.shape, S)
    want[:, :K, :] = np.arange(C)          # C <= S here
    np.testing.assert_array_equal(tok.numpy(), want)
    np.testing.assert_allclose(gate[:, :K].numpy(), 1.0 / K, rtol=1e-6)


@pytest.mark.parametrize("seq", [1, S])
def test_apply_moe_matches_reference(model, seq):
    """The layer's output and aux on random hidden states: deepseek's
    smoke variant has a shared expert, qwen3's has none."""
    jm, pm = model.layer_moe()
    x = np.random.default_rng(4).standard_normal(
        (B, seq, model.cfg.d_model)).astype(np.float32)
    want, jaux = jax_moe.apply_moe(model.jcfg, jm, jnp.asarray(x))
    got, aux = moe.apply_moe(model.cfg, pm, torch.tensor(x))
    assert got.shape == (B, seq, model.cfg.d_model)
    assert bool(model.cfg.num_shared_experts) == ("shared_up" in pm)
    _close(got, want, 1e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


def test_forward_matches_reference(model):
    """Smoke forward logits and the aux summed over layers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        want, jaux, _ = jax_api.get_model(model.jcfg).forward(
            model.jcfg, model.jp, jnp.asarray(model.toks), JaxRun())
    logits, aux, _ = transformer.forward(
        model.cfg, model.params, torch.tensor(model.toks, dtype=torch.int64),
        RunConfig())
    assert logits.shape == (B, S, model.cfg.vocab_size)
    _close(logits, want, 1e-4, scaled=True)
    assert float(jaux) > 0
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def test_prefill_and_decode_match_reference_pallas(model):
    """Prefill and three decode steps (float32 cache) against the
    reference with its Pallas kernels in interpret mode; each step feeds
    the reference's greedy token to both."""
    jrun, run = JaxRun(kv_cache_dtype="float32"), RunConfig(
        kv_cache_dtype="float32")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jl, jcache = jax_api.make_prefill_step(model.jcfg, jrun, MAX_LEN)(
            model.jp, jnp.asarray(model.toks))
        jdec = jax_api.make_decode_step(model.jcfg, jrun)
        jsteps, tok = [], model.toks[:, -1:]
        for _ in range(3):
            out, jcache = jdec(model.jp, jnp.asarray(tok), jcache)
            jsteps.append((tok, out))
            tok = np.asarray(jnp.argmax(out[:, -1], -1))[:, None]
    pl, cache = api.make_prefill_step(model.cfg, run, MAX_LEN)(
        model.params, torch.tensor(model.toks, dtype=torch.int64))
    _close(pl, jl, 1e-4, scaled=True)
    dec = api.make_decode_step(model.cfg, run)
    for tok, want in jsteps:
        got, cache = dec(model.params, torch.tensor(np.asarray(tok),
                                                    dtype=torch.int64), cache)
        _close(got, want, 1e-4, scaled=True)
    np.testing.assert_array_equal(cache["pos"].numpy(), [S + 3] * B)


def test_remat_block_gives_the_same_logits_aux_and_grads(model):
    """remat="block" recomputes each layer in the backward: the same
    logits and aux, and the loss's gradients within 1e-6 of each leaf's
    largest |g|."""
    t = torch.tensor(model.toks, dtype=torch.int64)
    labels = torch.roll(t, -1, dims=1)
    out = {}
    for remat in ("none", "block"):
        run = RunConfig(remat=remat)
        params = jax.tree_util.tree_map(
            lambda v: v.detach().clone().requires_grad_(True),
            model.params)
        logits, aux, _ = transformer.forward(model.cfg, params, t, run)
        loss, _ = api.make_train_step(model.cfg, run)(params, t, labels)
        loss.backward()
        out[remat] = logits.detach(), float(aux.detach()), params
    assert torch.equal(out["none"][0], out["block"][0])
    assert out["none"][1] == out["block"][1] > 0
    g0 = jax.tree_util.tree_leaves(out["none"][2])
    g1 = jax.tree_util.tree_leaves(out["block"][2])
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        scale = float(a.grad.abs().max())
        assert float((a.grad - b.grad).abs().max()) <= 1e-6 * max(scale,
                                                                 1e-30)


@pytest.mark.parametrize("arch", ARCHS)
def test_provisioner_serves_moe_like_reference(arch):
    """Provisioner(workload=DecodeWorkload(arch=...)) on the smoke
    variant, default bfloat16 cache: plan, mean quality and greedy
    tokens equal to repro.api.Provisioner's with the same params."""
    scn = dict(K=3, tau_min=0.8, tau_max=1.5, content_bits=1024.0, seed=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        jwl = JaxWorkload(arch=arch)
        ref = JaxProvisioner(jax_scenario(**scn), workload=jwl,
                             scheduler="stacking",
                             allocator="inv_se").run(jax.random.PRNGKey(0))
    cfg = smoke_variant(get_config(arch))
    wl = DecodeWorkload(arch=arch, params=params_from_numpy(
        transformer.schema(cfg),
        jax.tree_util.tree_map(np.asarray, jwl.params), "cpu"),
        device="cpu")
    got = Provisioner(make_scenario(**scn), workload=wl,
                      scheduler="stacking", allocator="inv_se",
                      device="cpu").run()
    assert wl.cfg == cfg and wl.cfg.is_moe
    assert got.plan.batches == ref.plan.batches
    assert got.mean_fid == ref.mean_fid
    for k, toks in ref.content.items():
        assert got.content[k] == list(toks)
        assert len(toks) == ref.plan.steps_completed[k] > 0


@pytest.mark.parametrize("name,mine,ref", [
    ("deepseek-moe-16b", DEEPSEEK, JAX_DEEPSEEK),
    ("qwen3-moe-30b-a3b", QWEN3, JAX_QWEN3)])
def test_config_copies_match_reference(name, mine, ref):
    """The copies are the reference's field for field, registered, with
    the same analytic count; the schema adds the norm scales (2L+1, and
    qwen3's per-head q/k norms) the count leaves out."""
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert config.get_config(name) is mine
    assert mine.param_count() == ref.param_count()
    assert dataclasses.asdict(smoke_variant(mine)) \
        == dataclasses.asdict(jax_smoke(ref))
    n = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
        transformer.schema(mine), is_leaf=lambda x: hasattr(x, "init")))
    norms = (2 * mine.num_layers + 1) * mine.d_model
    if mine.qk_norm:
        norms += 2 * mine.num_layers * mine.resolved_head_dim
    assert n == mine.param_count() + norms
    assert mine.resolved_head_dim == 128


def test_model_api_maps_moe_to_the_transformer():
    cfg = smoke_variant(DEEPSEEK)
    assert api.get_model(cfg) is transformer
    assert api.extra_input_specs(cfg, 2, abstract=False) is None
    assert "moe" in transformer.schema(cfg)["layers"]
    assert "mlp" not in transformer.schema(cfg)["layers"]


def test_moe_and_serve_import_without_jax():
    """The MoE layer, its configs and the serve launcher import with jax
    blocked, and no module of repro gets loaded."""
    code = r"""
import sys
sys.modules["jax"] = None
import repro_torch.models.moe, repro_torch.launch.serve
import repro_torch.configs.deepseek_moe_16b
import repro_torch.configs.qwen3_moe_30b_a3b
bad = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
assert not bad, bad
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
