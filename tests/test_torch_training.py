"""The port's training path against ``repro.training`` and the
reference's loss, on the same numpy inputs and params (the reference's
``init_model`` or std-0.02 weights, carried across with
``params_from_numpy``), on the CPU.

The reference's gradient comes from its default CPU mode, the jnp path:
its Pallas kernels have no VJP (``jax.grad`` through them fails), so
REPRO_FORCE_PALLAS stays unset here.  Tolerances:

  * ``lr_at``: 1e-7 relative; ``apply_updates`` on one tree: params, m
    and v within 1e-6 (float32 elementwise arithmetic in one order);
  * loss: 1e-5 relative; each gradient leaf within 1e-4 x that leaf's
    largest |g| (float32 sums over two layers in other orders; 1e-3 for
    TinyLlama at the reference's init, see ``_model``);
  * three ``train_loop`` steps on std-0.02 weights: losses within 1e-4
    relative (AdamW's m / sqrt(v) turns the reference init's gradient
    gap into whole lr-sized steps on its smallest entries);
  * checkpoints: ``==`` both ways; ``remat="block"``: ``==``.
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
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch.config import RunConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.params import (map_schema,  # noqa: E402
                                       opt_state_from_numpy,
                                       params_from_numpy)
from repro_torch.training import checkpoint, optimizer as opt  # noqa: E402
from repro_torch.training import train  # noqa: E402
from repro_torch.training.data import DataConfig, batches  # noqa: E402

ARCHS = ["tinyllama-1.1b", "zamba2-2.7b", "deepseek-moe-16b", "whisper-tiny",
         "xlstm-125m", "llama-3.2-vision-90b"]
B, S = 2, 16
GATES = (0.5, 1.0)     # the VLM's cross-layer gates, drawn uniform


def _configs(arch):
    return smoke_variant(get_config(arch)), jax_smoke(jax_get_config(arch))


def _model(arch, init="reference", seed=0):
    """(cfg, jax cfg, jax params, port params on the CPU).  ``init``
    "reference": the reference's ``init_model``; "std0.02": every random
    leaf normal(0, 0.02) from numpy (norm scales 1), as chip_smoke.py's
    parity weights.  The reference's init gives wq and wk a fan_in of H
    and KV, so TinyLlama's attention scores reach ~64 and each softmax is
    nearly one-hot, which magnifies float32 rounding
    (``test_reference_init_gradient_gap_is_matmul_rounding``)."""
    cfg, jcfg = _configs(arch)
    schema = api.get_model(cfg).schema(cfg)
    rng = np.random.default_rng(seed)
    if init == "reference":
        jp = jax_api.init_model(jcfg, jax.random.PRNGKey(seed))
    else:
        jp = map_schema(lambda p, _: (
            np.ones(p.shape, np.float32) if p.init == "ones" else
            np.zeros(p.shape, np.float32) if p.init == "zeros" else
            (rng.standard_normal(p.shape) * 0.02).astype(np.float32)),
            schema)
        jp = jax.tree_util.tree_map(jnp.asarray, jp)
    if cfg.cross_attn_every:
        cross = jp["groups"]["cross"]
        for g in ("gate_attn", "gate_mlp"):
            cross[g] = jnp.asarray(rng.uniform(*GATES, cross[g].shape)
                                   .astype(np.float32))
    return cfg, jcfg, jp, params_from_numpy(schema, jp, "cpu")


def _extras(cfg, seed=5, batch=B):
    """The modality inputs, drawn normal(0, 1) from ``seed`` as numpy
    (batch, memory rows, d): whisper's frames, the VLM's vision
    embeddings; None for the other families.  The reference's stubs
    (zeros, and 0.02 everywhere) make every memory row equal, so the
    cross attention would be uniform and whisper's encoder would see
    zeros."""
    M = cfg.num_audio_frames or cfg.num_vision_tokens
    if not M:
        return None
    key = "audio_frames" if cfg.family == "audio" else "vision_embeds"
    x = np.random.default_rng(seed).standard_normal((batch, M, cfg.d_model))
    return {key: x.astype(np.float32)}


def _jax_extras(extras):
    return None if extras is None else {
        k: jnp.asarray(v) for k, v in extras.items()}


def _torch_extras(extras):
    return None if extras is None else {
        k: torch.as_tensor(v) for k, v in extras.items()}


def _batch(vocab, seed=0, batch=B, seq=S):
    return next(batches(DataConfig(vocab_size=vocab, seq_len=seq,
                                   global_batch=batch, seed=seed)))


def _flat(tree):
    """Leaves by the checkpoint's flattened key, as float numpy."""
    if isinstance(jax.tree_util.tree_leaves(tree)[0], torch.Tensor):
        return checkpoint._flatten(tree)
    return jax_ckpt._flatten(tree)


def _close_tree(got, want, tol, scaled=True):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for key in w:
        atol = tol * float(np.abs(w[key]).max()) if scaled else tol
        np.testing.assert_allclose(g[key], w[key], atol=atol,
                                   rtol=0 if scaled else tol, err_msg=key)


def _port_loss_and_grads(cfg, params, toks, labels, run=None, extras=None):
    params = train.trainable(params)
    for p in opt.leaves(params):
        p.grad = None
    loss, nll = train.make_loss_fn(cfg, run or RunConfig())(
        params, torch.as_tensor(toks), torch.as_tensor(labels),
        _torch_extras(extras))
    loss.backward()
    return loss.detach(), nll.detach(), opt.tree_map(lambda p: p.grad,
                                                     params)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_reference(schedule):
    """Every step 0..59 within 1e-7 relative.  The cosine schedule also
    allows lr x 2^-24: XLA's and PyTorch's float32 cos differ by one ulp
    (2^-24 at |cos| in [0.5, 1)) at some arguments (step 36 here), and
    0.5 (1 + cos) keeps that error absolute, which near the end of the
    decay is more than 1e-7 of the value."""
    ocfg = dict(lr=1e-3, warmup_steps=7, total_steps=50, schedule=schedule)
    pc, jc = opt.AdamWConfig(**ocfg), jax_opt.AdamWConfig(**ocfg)
    ulp = pc.lr * 2.0 ** -24 if schedule == "cosine" else 0
    for step in range(60):
        want = float(jax_opt.lr_at(jc, step))
        assert float(opt.lr_at(pc, step)) == pytest.approx(want, rel=1e-7,
                                                           abs=ulp)
        got = opt.lr_at(pc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-7, abs=ulp)


@pytest.mark.parametrize("grad_clip,scale", [(1.0, 1.0), (1.0, 100.0),
                                             (0.0, 1.0)])
def test_apply_updates_matches_reference(grad_clip, scale):
    """Two AdamW steps on a random tree (a dict, a list, several shapes):
    params, m and v within 1e-6; grad norm and lr within 1e-6 relative.
    ``scale`` 100 puts the gradient norm over the clip."""
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": [(3,), (2, 3, 4)], "c": {"d": (11,)}}
    tree = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10,
                grad_clip=grad_clip)
    pc, jc = opt.AdamWConfig(**ocfg), jax_opt.AdamWConfig(**ocfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    pp = jax.tree_util.tree_map(torch.tensor, tree)
    js, ps = jax_opt.init_state(jp), opt.init_state(pp)
    for step in range(2):
        g = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(
                np.float32), tree)
        jp, js, jm = jax_opt.apply_updates(
            jc, jp, jax.tree_util.tree_map(jnp.asarray, g), js)
        pp, ps, pm = opt.apply_updates(
            pc, pp, jax.tree_util.tree_map(torch.tensor, g), ps)
        assert int(ps["step"]) == int(js["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        for key in ("m", "v"):
            _close_tree(ps[key], js[key], 1e-6, scaled=False)
        _close_tree(pp, jp, 1e-6, scaled=False)


def test_checkpoints_restore_both_ways(tmp_path):
    """A port checkpoint restores in the reference and a reference one
    in the port, every entry ``==``, under the reference's keys."""
    cfg, jcfg, jp, pp = _model("tinyllama-1.1b")
    jblob = {"params": jp, "opt": jax_opt.init_state(jp),
             "meta": [1, (2, 3)]}
    ps = opt.init_state(pp)
    ps["m"]["embed"]["tok"] += 0.5
    pblob = {"params": pp, "opt": ps, "meta": [1, (2, 3)]}
    port_file, ref_file = str(tmp_path / "port.npz"), str(tmp_path / "r.npz")
    checkpoint.save(port_file, pblob)
    jax_ckpt.save(ref_file, jblob)
    assert set(np.load(port_file).files) == set(np.load(ref_file).files)
    for got, want in ((jax_ckpt.restore(port_file, jblob), pblob),
                      (checkpoint.restore(ref_file, pblob), jblob)):
        g, w = _flat(got), _flat(want)
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            assert g[key].dtype == w[key].dtype
    back = checkpoint.restore(port_file, pblob)
    assert isinstance(back["params"]["layers"]["attn"]["wq"], torch.Tensor)
    assert back["opt"]["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="embed/tok"):
        checkpoint.restore(port_file, {"params": {"embed": {
            "tok": torch.zeros(3)}}})


def _value_and_grad(jcfg, jp, toks, labels, extras=None):
    return jax.value_and_grad(
        jax_train.make_loss_fn(jcfg, JaxRun()), has_aux=True)(
            jp, jnp.asarray(toks), jnp.asarray(labels), _jax_extras(extras))


# (arch, init): the reference's init where it is well conditioned, and
# std-0.02 weights for every family
LOSS_CASES = [pytest.param(a, "reference", id=f"reference-{a}")
              for a in ("tinyllama-1.1b", "zamba2-2.7b", "xlstm-125m")] + [
    pytest.param(a, "std0.02", id=f"std0.02-{a}") for a in ARCHS]
# leaves whose gradient is zero in exact arithmetic, by arch: a shift of
# the sLSTM's input-gate bias scales i at every step, and with it c and
# n alike from their zero start, so h = o c / n does not move; both
# sides carry float32 rounding there (6e-10 to 9e-10 of the largest |g|)
ROUNDING_ONLY = {"xlstm-125m": {"groups/slstm/bi"}}
ROUNDING_TOL = 1e-6      # x the largest |g| over all leaves


def _close_grads(got, want, tol, rounding_only=()):
    """``_close_tree`` on gradients, each leaf within ``tol`` x its
    largest |g|, but the ``rounding_only`` leaves: on both sides within
    ROUNDING_TOL x the largest |g| over all leaves."""
    g, w = _flat(got), _flat(want)
    top = max(float(np.abs(a).max()) for a in w.values())
    for key in rounding_only:
        for side in (g, w):
            assert float(np.abs(side.pop(key)).max()) <= ROUNDING_TOL * top
    assert g.keys() == w.keys()
    for key in w:
        np.testing.assert_allclose(g[key], w[key], rtol=0, err_msg=key,
                                   atol=tol * float(np.abs(w[key]).max()))


@pytest.mark.parametrize("arch,init", LOSS_CASES)
def test_loss_and_grads_match_jax_value_and_grad(arch, init):
    """Loss and nll within 1e-5 relative; every gradient leaf within
    1e-4 x its largest |g|, but TinyLlama at the reference's init, whose
    gap (4.0e-4) the next test accounts for, and the leaves whose
    gradient is only rounding (ROUNDING_ONLY).  The VLM's cross-layer
    gates are drawn uniform in GATES (the reference's zeros give
    tanh(0) = 0, so every cross-layer weight would get a zero gradient),
    and whisper's frames and the VLM's vision embeddings are drawn
    normal(0, 1) (``_extras``).  deepseek, whisper and the VLM run on
    std-0.02 weights only: at the reference's init their attention is
    ill-conditioned as TinyLlama's is (wq and wk take a fan_in of H and
    KV, so the softmaxes are near one-hot), and the gaps measured there
    were 5.9e-4 (deepseek; float64 products in the port cut it to 3.4e-4
    only, the rest is the reference's own float32 error), 5.7e-3
    (whisper; the reference's own Pallas and jnp paths differ by 1.17e-3
    at that init) and 3.7e-4 (the VLM; 9.4e-5 with float64 products).
    Every family's gradient reaches every leaf (each leaf's largest |g|
    > 0)."""
    cfg, jcfg, jp, pp = _model(arch, init)
    toks, labels = _batch(cfg.vocab_size)
    extras = _extras(cfg)
    (jloss, jnll), jg = _value_and_grad(jcfg, jp, toks, labels, extras)
    loss, nll, grads = _port_loss_and_grads(cfg, pp, toks, labels,
                                            extras=extras)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(nll) == pytest.approx(float(jnll), rel=1e-5)
    assert all(float(g.abs().max()) > 0 for g in opt.leaves(grads))
    _close_grads(grads, jg, 1e-3 if (arch, init) == (ARCHS[0], "reference")
                 else 1e-4, ROUNDING_ONLY.get(arch, ()))


def _gap(got, want):
    g, w = _flat(got), _flat(want)
    return max(float(np.abs(g[k] - w[k]).max() / np.abs(w[k]).max())
               for k in w)


def test_reference_init_gradient_gap_is_matmul_rounding(monkeypatch):
    """TinyLlama at the reference's init: the port's gradients part from
    the reference's by up to 4.0e-4 of a leaf's largest |g|, against
    1e-4 on std-0.02 weights.  Witness that it is the float32 rounding of
    the CPU's matrix products (PyTorch's and XLA's libraries round
    differently), magnified by near one-hot softmaxes, and no wrong
    formula: with every ``@`` of the port carried out in float64 the gap
    falls by more than half, to 1.5e-4, which is the order of the
    reference's own float32 error there (8.7e-5 from a float64 run of
    it, measured once)."""
    cfg, jcfg, jp, pp = _model("tinyllama-1.1b")
    toks, labels = _batch(cfg.vocab_size)
    _, jg = _value_and_grad(jcfg, jp, toks, labels)
    gap32 = _gap(_port_loss_and_grads(cfg, pp, toks, labels)[2], jg)
    mm = torch.Tensor.__matmul__
    monkeypatch.setattr(torch.Tensor, "__matmul__", lambda a, b: mm(
        a.double(), b.double()).to(torch.promote_types(a.dtype, b.dtype)))
    pp = _model("tinyllama-1.1b")[3]
    gap64 = _gap(_port_loss_and_grads(cfg, pp, toks, labels)[2], jg)
    assert 1e-4 < gap32 < 1e-3 and gap64 < gap32 / 2, (gap32, gap64)


def test_remat_block_gives_the_same_loss_and_grads():
    """``remat="block"`` recomputes each layer in the backward: the same
    loss and grads, ``==``; ``"full"`` does nothing, as in the
    reference's dense transformer."""
    cfg, _, jp, _ = _model("tinyllama-1.1b")
    toks, labels = _batch(cfg.vocab_size)
    schema = api.get_model(cfg).schema(cfg)
    out = {remat: _port_loss_and_grads(
        cfg, params_from_numpy(schema, jp, "cpu"), toks, labels,
        RunConfig(remat=remat)) for remat in ("none", "block", "full")}
    for remat in ("block", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(opt.leaves(out[remat][2]), opt.leaves(out["none"][2])):
            assert torch.equal(a, b)


# every family's remat variants that the reference has, against "none";
# "full" recomputes nothing in any family
REMAT_CASES = [("zamba2-2.7b", "block"), ("zamba2-2.7b", "group"),
               ("whisper-tiny", "block"), ("xlstm-125m", "block"),
               ("xlstm-125m", "group"), ("llama-3.2-vision-90b", "block"),
               ("llama-3.2-vision-90b", "group"),
               ("llama-3.2-vision-90b", "full")]


@pytest.mark.parametrize("arch,remat", REMAT_CASES)
def test_remat_gives_the_same_loss_and_grads(arch, remat):
    """The reference's ``jax.checkpoint`` places, as
    ``torch.utils.checkpoint``: zamba2 and xLSTM each group under
    "block" and "group", whisper each decoder layer under "block", the
    VLM each self layer under "block" and each group (self layers and
    the cross layer) under "group".  The backward recomputes the same
    forward: the same loss (``==``), every gradient leaf within 1e-6 x
    its largest |g| (a recomputed segment's gradients join the stream's
    in another order)."""
    cfg, _, jp, _ = _model(arch, "std0.02")
    toks, labels = _batch(cfg.vocab_size)
    extras = _extras(cfg)
    schema = api.get_model(cfg).schema(cfg)
    out = {r: _port_loss_and_grads(
        cfg, params_from_numpy(schema, jp, "cpu"), toks, labels,
        RunConfig(remat=r), extras) for r in ("none", remat)}
    assert torch.equal(out[remat][0], out["none"][0])
    assert torch.equal(out[remat][1], out["none"][1])
    _close_tree(out[remat][2], out["none"][2], 1e-6)


def _jax_loop(arch, ocfg, dc, extras):
    cfg, jcfg, jp, pp = _model(arch, "std0.02")
    _, _, jhist = jax_train.train_loop(
        jcfg, JaxRun(), batches(dc), steps=3, params=jp, log_every=1,
        ocfg=jax_opt.AdamWConfig(**ocfg), extras=_jax_extras(extras))
    return cfg, pp, jhist


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_train_loop_with_extras_tracks_the_reference(arch):
    """Three steps of whisper and the VLM (std-0.02 weights, the VLM's
    gates drawn, extras drawn normal(0, 1) and given to both loops as
    numpy, which the port's loop puts on its device) from the same
    params on the same synthetic data: losses, nll and grad norms
    within 1e-4 relative, lr within 1e-6; the params come back
    released."""
    cfg = _configs(arch)[0]
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    extras = _extras(cfg)
    cfg, pp, jhist = _jax_loop(arch, ocfg, dc, extras)
    params, state, hist = train.train_loop(
        cfg, RunConfig(), batches(dc), steps=3, params=pp, device="cpu",
        log_every=1, ocfg=opt.AdamWConfig(**ocfg), extras=extras)
    assert int(state["step"]) == 3
    assert all(p.grad is None and not p.requires_grad
               for p in opt.leaves(params))
    for got, want in zip(hist, jhist, strict=True):
        for k in ("loss", "nll", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_train_loop_tracks_the_reference():
    """Three steps from the same params on the same synthetic data:
    losses, nll and grad norms within 1e-4 relative, lr within 1e-6."""
    cfg, jcfg, jp, pp = _model("tinyllama-1.1b", "std0.02")
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    _, _, jhist = jax_train.train_loop(
        jcfg, JaxRun(), batches(dc), steps=3, params=jp, log_every=1,
        ocfg=jax_opt.AdamWConfig(**ocfg))
    seen = []
    params, state, hist = train.train_loop(
        cfg, RunConfig(), batches(dc), steps=3, params=pp, device="cpu",
        log_every=1, ocfg=opt.AdamWConfig(**ocfg), callback=seen.append)
    assert seen == hist and [h["step"] for h in hist] == [0, 1, 2]
    assert int(state["step"]) == 3 and params is pp
    assert all(p.grad is None and not p.requires_grad
               for p in opt.leaves(params))
    for got, want in zip(hist, jhist, strict=True):
        for k in ("loss", "nll", "grad_norm"):
            assert got[k] == pytest.approx(want[k], rel=1e-4), k
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6)
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_jax_optimizer_state_resumes_in_the_port():
    """Two reference steps, then the params and AdamW state carried
    across (``opt_state_from_numpy``): the third step's loss, moments and
    params agree with the reference's third step."""
    cfg, jcfg, jp, _ = _model("tinyllama-1.1b", "std0.02")
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=5)
    step = jax.jit(jax_train.make_train_step(
        jcfg, JaxRun(), jax_opt.AdamWConfig(**ocfg)))
    js = jax_opt.init_state(jp)
    data = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                              global_batch=B))
    for _ in range(2):
        toks, labels = next(data)
        jp, js, _ = step(jp, js, jnp.asarray(toks), jnp.asarray(labels))
    schema = api.get_model(cfg).schema(cfg)
    pp = params_from_numpy(schema, jp, "cpu")
    ps = opt_state_from_numpy(schema, js, "cpu")
    assert ps["step"].dtype == torch.int32 and int(ps["step"]) == 2
    toks, labels = next(data)
    jp, js, jm = step(jp, js, jnp.asarray(toks), jnp.asarray(labels))
    pp, ps, pm = train.make_train_step(cfg, RunConfig(), opt.AdamWConfig(
        **ocfg))(pp, ps, torch.as_tensor(toks), torch.as_tensor(labels))
    assert float(pm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert int(ps["step"]) == 3
    for key in ("m", "v"):
        _close_tree(ps[key], js[key], 1e-4)
    _close_tree(pp, jp, 1e-4)


def test_loss_decreases_on_memorizable_data():
    """The port's copy of tests/test_serving_training.py's check: 30
    steps on one fixed batch bring the loss down by more than 0.3."""
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    fixed = _batch(cfg.vocab_size, batch=4, seq=32)
    _, _, hist = train.train_loop(
        cfg, RunConfig(kv_cache_dtype="float32"), iter(lambda: fixed, None),
        steps=30, log_every=29, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3


def test_launcher_writes_a_checkpoint_the_reference_restores(tmp_path,
                                                             capsys):
    path = str(tmp_path / "ck.npz")
    params, state = launch_train.main(
        ["--smoke", "--steps", "2", "--seq-len", "16", "--batch", "2",
         "--log-every", "1", "--device", "cpu", "--ckpt", path])
    out = capsys.readouterr().out
    assert "arch=tinyllama-1.1b-smoke" in out and "step     1  loss" in out
    assert "tok/s" in out and f"checkpoint -> {path}" in out
    _, jcfg = _configs("tinyllama-1.1b")
    jp = jax_api.init_model(jcfg, jax.random.PRNGKey(0))
    back = jax_ckpt.restore(path, {"params": jp,
                                   "opt": jax_opt.init_state(jp)})
    g, w = _flat(back), _flat({"params": params, "opt": state})
    assert g.keys() == w.keys() and int(g["opt/step"]) == 2
    assert all(p.grad is None and not p.requires_grad
               for p in opt.leaves(params))
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@pytest.mark.parametrize("remat", ["none", "block"])
def test_launcher_trains_whisper_on_the_cpu(tmp_path, capsys, remat):
    """``--arch whisper-tiny --smoke --device cpu``: the stub frames go
    to the CPU with the params, two steps run, and the checkpoint
    restores with the reference's ``checkpoint.restore`` under its
    keys, every entry ``==``."""
    path = str(tmp_path / "ck.npz")
    params, state = launch_train.main(
        ["--arch", "whisper-tiny", "--smoke", "--steps", "2", "--seq-len",
         "16", "--batch", "2", "--log-every", "1", "--device", "cpu",
         "--remat", remat, "--ckpt", path])
    out = capsys.readouterr().out
    assert "arch=whisper-tiny-smoke" in out and "step     1  loss" in out
    _, jcfg = _configs("whisper-tiny")
    jp = jax_api.init_model(jcfg, jax.random.PRNGKey(0))
    back = jax_ckpt.restore(path, {"params": jp,
                                   "opt": jax_opt.init_state(jp)})
    g, w = _flat(back), _flat({"params": params, "opt": state})
    assert g.keys() == w.keys() and int(g["opt/step"]) == 2
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_launcher_refuses_model_parallel_and_a_missing_card():
    # a world of one (no process group, no torchrun) has no room for a
    # model axis of 2; tests/test_torch_multidevice.py runs it on 4 ranks
    with pytest.raises(ValueError, match="--model-parallel 2 does not"):
        launch_train.main(["--smoke", "--model-parallel", "2",
                           "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            launch_train.main(["--smoke", "--steps", "1"])
        with pytest.raises(RuntimeError, match="is_available"):
            train.train_loop(smoke_variant(get_config("tinyllama-1.1b")),
                             RunConfig(), iter([]), steps=0)


def test_extra_inputs_and_trainable_params():
    """The stub inputs: None where a family takes none; whisper's zero
    frames and the VLM's 0.02 embeddings, shaped as the reference's, on
    the device asked for."""
    for arch in ARCHS:
        cfg = _configs(arch)[0]
        got = api.extra_input_specs(cfg, 2, abstract=False, device="cpu")
        want = jax_api.extra_input_specs(_configs(arch)[1], 2,
                                         abstract=False)
        if want is None:
            assert got is None
            continue
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    with pytest.raises(ValueError, match="unknown family"):
        api.extra_input_specs(dataclasses.replace(cfg, family="diffusion"),
                              2)
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(ValueError, match="leaf"):
        train.trainable({"w": w * 2})
    assert train.trainable({"w": torch.ones(2)})["w"].requires_grad


def test_train_step_raises_for_a_leaf_the_backward_missed(monkeypatch):
    """A wrapper whose output is detached (the hazard of a kernel
    launched outside its Function) leaves the leaves before it with no
    ``.grad``: the step raises, naming one, and updates nothing."""
    from repro_torch.models import layers
    cfg = smoke_variant(get_config("tinyllama-1.1b"))
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    before = opt.tree_map(torch.clone, params)
    norm = layers.rmsnorm
    monkeypatch.setattr(layers, "rmsnorm",
                        lambda *a, **kw: norm(*a, **kw).detach())
    toks, labels = _batch(cfg.vocab_size)
    step = train.make_train_step(cfg, RunConfig())
    with pytest.raises(ValueError, match="no gradient reached param "
                                         "(embed|layers)/"):
        step(params, opt.init_state(params), torch.as_tensor(toks),
             torch.as_tensor(labels))
    for a, b in zip(opt.leaves(params), opt.leaves(before)):
        assert torch.equal(a, b)


def _expected_calls(cfg, remat):
    """rmsnorm, flash and ssd_scan calls of one training forward and
    backward: each family's forward (chip_smoke.expected_launches' rule
    at one prefill), plus what ``remat`` recomputes: the block's norms
    and attention per layer (dense), each decoder layer's two attention
    calls (whisper), each group's kernels, all but the final norm
    (zamba2, xLSTM, and the VLM's groups under "group"), each self
    layer's (the VLM under "block")."""
    L = cfg.num_layers
    if cfg.family == "audio":
        again = 2 * L if remat == "block" else 0
        return {"rmsnorm": 0, "flash": cfg.encoder_layers + 2 * L + again,
                "ssd": 0}
    if cfg.family == "ssm":
        return {"rmsnorm": L * (1 + (remat in ("block", "group"))),
                "flash": 0, "ssd": 0}
    if cfg.family == "hybrid":
        G = L // cfg.shared_attn_every
        again = remat in ("block", "group")
        return {"rmsnorm": (2 * L + 2 * G) * (1 + again) + 1,
                "flash": G * (1 + again), "ssd": L * (1 + again)}
    n_self = L
    if cfg.cross_attn_every:
        n_self = L // cfg.cross_attn_every * (cfg.cross_attn_every - 1)
    again = {"block": n_self, "group": L}.get(remat, 0)
    if remat == "group" and not cfg.cross_attn_every:
        again = 0
    return {"rmsnorm": 2 * (L + again) + 1, "flash": L + again, "ssd": 0}


@pytest.mark.parametrize("arch,remat", [("tinyllama-1.1b", "none"),
                                        ("tinyllama-1.1b", "block"),
                                        ("zamba2-2.7b", "none"),
                                        ("zamba2-2.7b", "group"),
                                        ("deepseek-moe-16b", "none"),
                                        ("whisper-tiny", "none"),
                                        ("whisper-tiny", "block"),
                                        ("xlstm-125m", "group"),
                                        ("llama-3.2-vision-90b", "block"),
                                        ("llama-3.2-vision-90b", "group")])
def test_kernel_functions_give_the_plain_gradients(monkeypatch, arch,
                                                   remat):
    """The card's path on the CPU: every rmsnorm, flash-attention and
    ssd_scan call goes through ``kernels.with_grad`` into its
    ``KernelFunction`` (the launch runs with grad mode off, as inside a
    Function's forward), with the kernel launch replaced by the plain
    version (no card here).  The loss ``==`` plain autograd's, and every
    gradient leaf within 1e-5 x its largest |g| (measured 8.0e-7): a
    Function adds the two paths of x's gradient inside its own backward
    before autograd adds the sum to the residual stream's, so float32
    sums round in another order (the xLSTM's input-gate bias, whose
    gradient is only rounding, within ROUNDING_TOL of the largest).
    Under remat the backward re-runs the recomputed segments' kernels
    (``_expected_calls``).  Whisper reaches flash unmasked (its encoder
    over the frames, its cross attention at Sq != Skv) and causal;
    deepseek's routed experts launch nothing."""
    from repro_torch.kernels import with_grad
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import layers, ssm, transformer, whisper, xlstm
    cfg, _, jp, _ = _model(arch, "std0.02")
    toks, labels = _batch(cfg.vocab_size)
    extras = _extras(cfg)
    schema = api.get_model(cfg).schema(cfg)
    run = RunConfig(remat=remat)
    want = _port_loss_and_grads(cfg, params_from_numpy(schema, jp, "cpu"),
                                toks, labels, run, extras)
    calls = {"rmsnorm": 0, "flash": 0, "ssd": 0}
    seen = set()

    def counted(name, fn):
        def launch(*args, **kw):
            assert not torch.is_grad_enabled(), f"{name} outside a Function"
            calls[name] += 1
            if name == "flash":
                seen.add((kw["causal"], args[0].shape[1] == args[1].shape[1]))
            return fn(*args, **kw)
        return launch
    monkeypatch.setattr(rms_ops, "_launch", counted("rmsnorm", rmsnorm_ref))
    monkeypatch.setattr(fa_ops, "_launch", counted("flash", attention_ref))
    monkeypatch.setattr(ssd_ops, "_launch", counted("ssd", ssd_scan_ref))

    def norm(x, scale, eps=1e-6):
        return with_grad(rms_ops._launch, rmsnorm_ref, (x, scale), eps=eps)

    def attend(q, k, v, *, causal, window=0):
        return with_grad(fa_ops._launch, attention_ref, (q, k, v),
                         causal=causal, window=window)
    for mod in (layers, ssm, xlstm):
        monkeypatch.setattr(mod, "rmsnorm", norm)
    for mod in (transformer, whisper):
        monkeypatch.setattr(mod, "chunked_attention", attend)
    monkeypatch.setattr(ssd_ops, "ssd_scan", lambda *a, chunk: with_grad(
        ssd_ops._launch, ssd_scan_ref, a, chunk=chunk))
    got = _port_loss_and_grads(cfg, params_from_numpy(schema, jp, "cpu"),
                               toks, labels, run, extras)
    assert torch.equal(got[0], want[0])
    _close_grads(got[2], want[2], 1e-5, ROUNDING_ONLY.get(arch, ()))
    assert calls == _expected_calls(cfg, remat)
    if cfg.family == "audio":
        # (causal, Sq == Skv): encoder, cross (S < frames) and self
        assert seen == {(False, True), (False, False), (True, True)}
