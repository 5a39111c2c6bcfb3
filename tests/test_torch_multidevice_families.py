"""The port's hybrid (zamba2), ssm (xLSTM), audio (whisper) and VLM
families sharded on a (data 2, model 2) mesh of 4 gloo ranks on the CPU,
against their unsharded run and the reference's single-device run.

One group of 4 rank processes (``tests/torch_ranks.py``, suite
``families``; it imports no jax and checks so) runs every case once for
the module: the four smoke configs at B=4, S=32, each with fsdp off and
on, on std-0.02 weights drawn from a seed (the VLM's tanh gates uniform
in [0.5, 1]) with drawn frames and vision embeddings: a prefill at
``max_len`` S + 4, one greedy decode step and one train step; whisper
with an int8 cache and the VLM with ``decode_inplace_cache``, a prefill
and 2 decode steps each; then ``launch/train.py --arch zamba2-2.7b
--model-parallel 2`` for 2 steps, its checkpoint restored sharded.
Serial time: ~60 s, most of it the ranks' run (~40 s).

Tolerances (of the largest |value|): 1e-5 against the unsharded port
for the loss, |g|, every grad leaf, prefill logits, each decode step
from the same cache and float32 cache entries; 1e-4 against the
reference's prefill (REPRO_FORCE_PALLAS=1).  Rounded state is held to
its rounding: zamba2's conv state is bfloat16 and the serving case's
cache int8, as in the reference, so a sum carried in another order may
round to the neighbouring value (one bf16 step, one int8 step), and the
decode step that reads it moves by up to 4.7e-5 (measured); the chained
run's decode over such a cache is held to 1e-4 and equal tokens, over
a float32 cache to 1e-5, the step from the unsharded cache to 1e-5.  The first AdamW step divides each gradient by
its own size, so an element whose gradient is near ``eps`` turns a
1e-7 difference in its sum into a larger one of its update: each run's
updated params are held to the AdamW step of its own gradients, and the
two runs' to 1e-5 plus what that step makes of their gradients'
difference.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.config import RunConfig as JaxRun  # noqa: E402
from repro.config import get_config as jax_config  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.params import map_schema  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_ranks as ranks  # noqa: E402

WORLD = 4
RANK_TIMEOUT = 240     # seconds for the group: a hung rendezvous fails
TOL = 1e-5
ROUNDED_TOL = 1e-4     # a decode that read rounded (bf16, int8) state
ROUNDED = ("torch.bfloat16", "torch.int8")
NAMES = [c[0] for c in ranks.FAMILY_CASES]
# leaves whose gradient is zero in exact arithmetic (both runs carry
# float32 rounding there, tests/test_torch_training.py), held to 1e-6
# of the largest |g| of all leaves
ROUNDING_ONLY = {"xlstm-125m": {"/groups/slstm/bi"}}
ROUNDING_TOL = 1e-6
# the kernels each family's prefill, decode and train step call
KERNELS = {"zamba2-2.7b": {"rmsnorm", "flash_attention", "decode_attention",
                           "ssd_scan"},
           "xlstm-125m": {"rmsnorm"},
           "whisper-tiny": {"flash_attention", "decode_attention"},
           "llama-3.2-vision-90b": {"rmsnorm", "flash_attention",
                                    "decode_attention"}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("multidevice_families")
    return out, ranks.run_group(out, "families", WORLD, RANK_TIMEOUT)


def _load(out, name):
    with np.load(out / f"{name}.npz") as z:
        return dict(z)


def _rel(want, got):
    return float(np.abs(want - got).max() / np.abs(want).max())


def _leaves(z, key):
    n = sum(1 for k in z if k.startswith(f"{key}_")
            and k[len(key) + 1:].isdigit())
    return [z[f"{key}_{i}"] for i in range(n)]


def _case(name):
    return next(c for c in ranks.FAMILY_CASES if c[0] == name)


def _paths(cfg):
    """Each param leaf's path, in ``optimizer.leaves`` order."""
    paths = []
    map_schema(lambda p, path: paths.append(path),
               api.get_model(cfg).schema(cfg))
    return paths


@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_unsharded(runs, name):
    """Loss, |g| and prefill logits within 1e-5; the decode step from
    the unsharded prefill's cache within 1e-5; the chained decode (from
    the sharded prefill's own cache) with equal tokens, within 1e-5, or
    1e-4 where the cache holds a rounded (bf16, int8) leaf."""
    z = _load(runs[0], name)
    assert abs(z["sharded_loss"] - z["plain_loss"]) \
        <= TOL * abs(z["plain_loss"])
    assert abs(z["sharded_gnorm"] - z["plain_gnorm"]) \
        <= TOL * abs(z["plain_gnorm"])
    assert _rel(z["plain_prefill"], z["sharded_prefill"]) < TOL
    assert _rel(z["plain_decode"], z["sharded_step"]) < TOL
    rounded = any(d in ROUNDED for d in z["cache_dtypes"].tolist())
    assert _rel(z["plain_decode"], z["sharded_decode"]) \
        < (ROUNDED_TOL if rounded else TOL)
    assert np.array_equal(z["plain_tokens"], z["sharded_tokens"])


@pytest.mark.parametrize("name", NAMES)
def test_sharded_grads(runs, name):
    """Every grad leaf within 1e-5 of its max |g|; a leaf whose gradient
    is only rounding within 1e-6 of the largest |g| on both sides."""
    z = _load(runs[0], name)
    cfg = ranks.config(_case(name)[1])
    plain, sharded = _leaves(z, "plain_grads"), _leaves(z, "sharded_grads")
    assert len(plain) == len(sharded) == len(_paths(cfg)) > 0
    top = max(float(np.abs(g).max()) for g in plain)
    rounding = ROUNDING_ONLY.get(_case(name)[1], set())
    for path, want, got in zip(_paths(cfg), plain, sharded):
        if path in rounding:
            assert max(np.abs(want).max(), np.abs(got).max()) \
                <= ROUNDING_TOL * top, path
            continue
        assert np.abs(want - got).max() <= TOL * np.abs(want).max(), path


def _adamw_first_step(p0, g, gnorm, ocfg):
    """The port's AdamW (``training.optimizer.apply_updates``) at step 1
    from zero moments, in float64: (updated params, the normalised
    gradient m^ / (sqrt(v^) + eps))."""
    g = g.astype(np.float64) * min(1.0, ocfg.grad_clip / (gnorm + 1e-9))
    lr = ocfg.lr * min(1.0 / max(ocfg.warmup_steps, 1), 1.0)
    u = g / (np.abs(g) + ocfg.eps)
    return p0 - lr * (u + ocfg.weight_decay * p0), u, lr


@pytest.mark.parametrize("name", NAMES)
def test_sharded_adamw_step(runs, name):
    """Each run's updated params are the AdamW step of its own gradients
    (1e-6 of each leaf's max |p|, float32 rounding of the step), and the
    two runs' updated params agree within 1e-5 of the leaf's max |p|
    plus lr times the difference of their normalised gradients."""
    z = _load(runs[0], name)
    cfg = ranks.config(_case(name)[1])
    p0 = [np.asarray(a, np.float64) for a in
          _flat_tree(ranks.draw_params(cfg))]
    ocfg = AdamWConfig()
    us = {}
    for key in ("plain", "sharded"):
        for i, (p, g, got) in enumerate(zip(
                p0, _leaves(z, f"{key}_grads"), _leaves(z, f"{key}_updated"),
                strict=True)):
            want, u, lr = _adamw_first_step(p, g, float(z[f"{key}_gnorm"]),
                                            ocfg)
            us[key, i] = u
            assert np.abs(want - got).max() <= 1e-6 * np.abs(want).max()
    for i, (want, got) in enumerate(zip(_leaves(z, "plain_updated"),
                                        _leaves(z, "sharded_updated"))):
        slack = lr * np.abs(us["plain", i] - us["sharded", i])
        assert np.all(np.abs(want - got)
                      <= TOL * np.abs(want).max() + slack * (1 + 1e-3))


def _flat_tree(tree):
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _flat_tree(v)]
    if isinstance(tree, (list, tuple)):
        return [a for v in tree for a in _flat_tree(v)]
    return [tree]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_caches(runs, name):
    """The prefill's and the decode step's caches placed as
    ``cache_pspecs`` says; the sharded prefill's cache against the
    unsharded one: integers equal, float32 entries within 1e-5 of the
    leaf's max, bfloat16 entries (zamba2's conv state) within one
    bfloat16 step."""
    z = _load(runs[0], name)
    assert bool(z["placed"])
    for dtype, want, got in zip(z["cache_dtypes"], _leaves(z, "plain_cache"),
                                _leaves(z, "sharded_cache"), strict=True):
        if dtype in ("torch.int32", "torch.int8"):
            assert np.array_equal(want, got)
        elif dtype == "torch.bfloat16":
            step = 2.0 ** -7 * np.maximum(np.abs(want), np.abs(got))
            assert np.all(np.abs(want - got) <= step)
        else:
            assert dtype == "torch.float32"
            assert np.abs(want - got).max() \
                <= TOL * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_kernel_calls(runs, name):
    """The sharded run called each kernel wrapper as often as the
    unsharded run, on local blocks (a wrapper refuses a DTensor), and
    the family's kernels at least once: ``ssd_scan`` through
    ``local_map`` in zamba2's prefill and train step."""
    z = _load(runs[0], name)
    assert np.array_equal(z["plain_calls"], z["sharded_calls"])
    calls = dict(zip(ranks.WRAPPERS, z["sharded_calls"].tolist()))
    want = KERNELS[_case(name)[1]]
    assert {k for k, n in calls.items() if n} == want, calls


_REFERENCE = {}


def _reference_prefill(arch):
    """The reference's single-device prefill logits on the drawn params,
    tokens and extras (REPRO_FORCE_PALLAS=1: its Pallas kernels in
    interpret mode), once per arch."""
    if arch not in _REFERENCE:
        cfg = ranks.config(arch)
        toks, _ = ranks.draw_tokens(cfg)
        extras = ranks.draw_extras(cfg)
        jextras = None if extras is None else {
            k: jnp.asarray(v) for k, v in extras.items()}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("REPRO_FORCE_PALLAS", "1")
            logits, _ = jax_api.make_prefill_step(
                jax_smoke(jax_config(arch)), JaxRun(kv_cache_dtype="float32"),
                ranks.S + 4)(ranks.draw_params(cfg), jnp.asarray(toks),
                             jextras)
        _REFERENCE[arch] = np.asarray(logits)
    return _REFERENCE[arch]


@pytest.mark.parametrize("name", NAMES)
def test_sharded_matches_the_reference(runs, name):
    """The sharded prefill against the reference's single-device prefill
    on the same params, tokens and extras, within 1e-4 of the largest
    |logit|."""
    want = _reference_prefill(_case(name)[1])
    got = _load(runs[0], name)["sharded_prefill"]
    assert _rel(want, got) < 1e-4


@pytest.mark.parametrize("name", [c[0] for c in ranks.FAMILY_SERVE_CASES])
def test_sharded_serving(runs, name):
    """whisper with an int8 cache (its cross caches' ``{"q", "s"}``
    placed) and the VLM with ``decode_inplace_cache`` on the mesh: the
    cache placed as ``cache_pspecs`` says, tokens equal, each decode
    step from the unsharded run's cache within 1e-5 of the largest
    logit, the chained run's within 1e-4 over the int8 cache (its
    rounding), 1e-5 over the float32 one."""
    z = _load(runs[0], name)
    assert bool(z["placed"])
    assert np.array_equal(z["plain_tokens"], z["sharded_tokens"])
    assert _rel(z["plain_logits"][0], z["sharded_logits"][0]) < TOL
    for want, got in zip(z["plain_logits"][1:], z["sharded_steps"],
                         strict=True):
        assert _rel(want, got) < TOL
    knobs = next(c[3] for c in ranks.FAMILY_SERVE_CASES if c[0] == name)
    tol = ROUNDED_TOL if knobs["kv_cache_dtype"] == "int8" else TOL
    for want, got in zip(z["plain_logits"], z["sharded_logits"]):
        assert _rel(want, got) < tol


def test_launcher_model_parallel_zamba2(runs, capsys):
    """``launch/train.py --arch zamba2-2.7b --model-parallel 2`` on the 4
    ranks: its losses are the unsharded launcher's, its checkpoint
    (written whole by rank 0) has the unsharded one's keys and shapes,
    and restores into the sharded tree, each leaf placed as the
    launcher's."""
    out, logs = runs
    from repro_torch.launch import train as launch_train
    plain_ckpt = out / "plain_launcher.npz"
    launch_train.main(ranks.unsharded_launcher(ranks.FAMILY_LAUNCHER)
                      + ["--ckpt", str(plain_ckpt)])
    plain = capsys.readouterr().out
    assert "arch=zamba2-2.7b-smoke" in logs[0]
    assert "mesh={'data': 2, 'model': 2} devices=4" in logs[0]

    def losses(text):
        return [ln.split("lr")[0] for ln in text.splitlines()
                if ln.startswith("step")]
    assert losses(logs[0]) == losses(plain) and len(losses(plain)) == 2
    assert all("step" not in log for log in logs[1:])
    with np.load(out / "launcher.npz") as a, np.load(plain_ckpt) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape, k
        assert int(a["opt/step"]) == 2
    with np.load(out / "restore.npz") as r:
        assert float(r["err"]) == 0.0 and bool(r["placed"])


def test_ssd_scan_and_groupnorm_silu_refuse_a_dtensor(tmp_path):
    """In a gloo world of one, both wrappers raise ``TypeError`` on a
    DTensor, as the other three do: they hand raw pointers to their
    kernels, and a sharded model reaches them through ``local_map``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.groupnorm_silu import ops as gn
    from repro_torch.kernels.ssd_scan import ops as ssd
    from repro_torch.models.params import PS, shard_as
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))

        def d(*shape):
            return shard_as(torch.zeros(shape), mesh, PS("data"))
        calls = {
            "ssd_scan": lambda: ssd.ssd_scan(
                d(1, 4, 2, 8), d(1, 4, 2), d(1, 4, 8), d(1, 4, 8),
                d(1, 2, 8, 8), chunk=4),
            "groupnorm_silu": lambda: gn.groupnorm_silu(
                d(1, 2, 2, 8), torch.ones(8), torch.zeros(8), 2)}
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"{name}.*local_map"):
                call()
    finally:
        dist.destroy_process_group()
