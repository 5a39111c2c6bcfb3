"""KV caches split along their sequence axis: ``shard_kv_seq`` (the
cache's sequence on ``data``) and the ``--opt`` decode rules'
``kv_seq`` on ``model``, decoded through ``decode_attention_block``
and a cross-rank log-sum-exp combine (``models/layers.py``), with
writes into each rank's rows (``models/kv_cache.py``).

One group of 4 gloo rank processes (``tests/torch_ranks.py``, suite
``kvseq``; it imports no jax and checks so), a (data 2, model 2) mesh,
runs every case of ``KVSEQ_CASES`` once for the module: a smoke config
at B=4, a 32-token prompt into a 36-row cache, and 3 greedy decode
steps, unsharded and sharded on the same std-0.02 weights (the VLM's
gates in [0.5, 1], drawn frames and vision embeddings): TinyLlama,
deepseek, zamba2, whisper and the VLM with the sequence on data and the
batch replicated; TinyLlama with one KV head under the --opt decode
rules (sequence on model, batch on data), by the kernel and in place;
a bfloat16 in-place case and an int8 cache; slice reads with the
positions drawn so that a data rank's own minimum is not the batch's,
over a whole sequence, over one split on data and one split on model,
and in place; and the reference's train rules, the activations'
sequence on model (queries split along it attend over gathered keys),
a prefill and the loss: TinyLlama (and with 3 heads, whole on the
model axis), deepseek, whisper and the VLM.  ~25 s serial.

Tolerances (of the largest |value|): 1e-5 against the unsharded port
for the logits of each step from the same cache and of the chained run,
and for float32 cache entries; zamba2's prefill leaves its conv state
in bfloat16, so a sum carried in another order may round to the
neighbouring value, and its chained run and cache are held to 1e-4
(as tests/test_torch_multidevice_families.py holds them); bfloat16
cache entries to one rounding step (2^-8), int8 ones to one step.
Tokens equal.  One case of each kind (the kernel path, slice reads,
in place) is also held against the reference's own prefill and decode
steps on one CPU device, on the same params, positions and tokens, at
1e-5 of the largest |logit|.  The block variant's plain version: split
into blocks and combined, within 1e-6 of the whole; against the
reference's Pallas kernel in interpret mode at 2e-5 (float32)."""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from repro.config import RunConfig as JaxRun  # noqa: E402
from repro.config import get_config as jax_config  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_block_ref, decode_attention_ref, lse_combine)
from repro_torch.launch import shardings as shd  # noqa: E402
from repro_torch.models import kv_cache  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import torch_ranks as ranks  # noqa: E402

WORLD = 4
RANK_TIMEOUT = 240     # seconds for the group: a hung rendezvous fails
TOL = 1e-5
ROUNDED_TOL = 1e-4     # zamba2: a decode that read its bf16 conv state
NAMES = [c[0] for c in ranks.KVSEQ_CASES]
# one case of each kind held against the reference: the kernel path,
# slice reads (per-rank minima that are not the batch's) and in place
REF_CASES = ["tinyllama", "tinyllama-kvseq-slice",
             "tinyllama-kv1-opt-inplace"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("kv_seq")
    return out, ranks.run_group(out, "kvseq", WORLD, RANK_TIMEOUT)


def _load(out, name):
    with np.load(out / f"{name}.npz") as z:
        return dict(z)


def _rel(want, got):
    return float(np.abs(want - got).max() / np.abs(want).max())


def _case(name):
    return next(c for c in ranks.KVSEQ_CASES if c[0] == name)


@pytest.mark.parametrize("name", NAMES)
def test_sequence_split_decode_matches_unsharded(runs, name):
    """The cache is placed by ``cache_pspecs``, its sequence split on
    data (rules "kv_seq") or on model (one KV head under the --opt
    decode rules) or whole ("default", "seq"); every decode step from
    the unsharded run's cache within 1e-5, the chained run within 1e-5
    (zamba2 1e-4), the prefill's too, tokens equal; under the train
    rules ("seq") the prefill and the loss within 1e-5."""
    z = _load(runs[0], name)
    _, arch, kv, kind, knobs, _ = _case(name)
    assert z["placed"]
    assert z["seq_dims"].tolist() == {"kv_seq": [0], "opt": [1],
                                      "default": [], "seq": []}[kind]
    if kind == "seq":
        assert abs(z["sharded_loss"] - z["plain_loss"]) \
            <= TOL * abs(z["plain_loss"])
    assert _rel(z["plain_logits"][0], z["sharded_logits"][0]) < TOL
    assert len(z["sharded_steps"]) == (0 if kind == "seq" else 3)
    if kind != "seq":
        assert _rel(z["plain_logits"][1:], z["sharded_steps"]) < TOL
    tol = ROUNDED_TOL if arch == "zamba2-2.7b" else TOL
    assert _rel(z["plain_logits"], z["sharded_logits"]) < tol
    assert np.array_equal(z["plain_tokens"], z["sharded_tokens"])


@pytest.mark.parametrize("name", NAMES)
def test_sequence_split_caches_match(runs, name):
    """Every leaf of the final cache, gathered, against the unsharded
    run's: float32 within 1e-5 (zamba2 1e-4), bfloat16 within one
    rounding step, int8 values within one step; positions equal."""
    z = _load(runs[0], name)
    arch = _case(name)[1]
    n = sum(1 for k in z if k.startswith("plain_cache_"))
    assert n == sum(1 for k in z if k.startswith("sharded_cache_")) >= 3
    for i, dtype in enumerate(z["cache_dtypes"].tolist()):
        want, got = z[f"plain_cache_{i}"], z[f"sharded_cache_{i}"]
        assert want.shape == got.shape
        if dtype == "torch.int32":
            assert np.array_equal(want, got)
        elif dtype == "torch.int8":
            assert np.abs(want - got).max() <= 1
        elif dtype == "torch.bfloat16":
            assert _rel(want, got) <= 2.0 ** -8
        else:
            assert _rel(want, got) <= (ROUNDED_TOL if arch == "zamba2-2.7b"
                                       else TOL), i


def _reference_chain(name, tokens):
    """The reference's single-device prefill and 3 decode steps on the
    case's drawn params, tokens and knobs (its shard_kv_seq places
    nothing without a mesh), fed the sharded run's greedy ``tokens``
    (B, 4), the positions set after the prefill as the ranks set them:
    its logits, (4, B, 1, V)."""
    _, arch, kv, _, knobs, positions = _case(name)
    cfg = ranks.config(arch, kv)
    jcfg = jax_smoke(jax_config(arch))
    if kv:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv)
    run = JaxRun(**knobs)
    params = ranks.draw_params(cfg)
    logits, cache = jax_api.make_prefill_step(jcfg, run, ranks.KV_LEN)(
        params, jnp.asarray(ranks.draw_tokens(cfg)[0]))
    if positions is not None:
        cache = dict(cache, pos=jnp.asarray(positions, jnp.int32))
    out = [np.asarray(logits)[:, -1:]]
    decode = jax_api.make_decode_step(jcfg, run)
    for i in range(3):
        logits, cache = decode(params, jnp.asarray(tokens[:, i:i + 1]),
                               cache)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("name", REF_CASES)
def test_sequence_split_decode_matches_the_reference(runs, name):
    """The sharded prefill and decode steps, each logits within 1e-5 of
    the largest |logit| of the reference's run on one CPU device on the
    same params, cache positions and tokens: a cache split on data
    through the block kernel, slice reads over one split on data, and
    the in-place branch over one split on model."""
    z = _load(runs[0], name)
    want = _reference_chain(name, z["sharded_tokens"])
    assert want.shape == z["sharded_logits"].shape
    for i, (a, b) in enumerate(zip(want, z["sharded_logits"])):
        assert _rel(a, b) < TOL, i


# ---------------------------------------------------------------------------
# The block variant's plain version
# ---------------------------------------------------------------------------

def _inputs(B, S, H, KV, D, seed=3):
    rng = np.random.default_rng(seed)
    return (torch.tensor(rng.standard_normal((B, 1, H, D)), dtype=torch.float32),
            torch.tensor(rng.standard_normal((B, S, KV, D)), dtype=torch.float32),
            torch.tensor(rng.standard_normal((B, S, KV, D)), dtype=torch.float32))


def _blocks(q, k, v, cur, n, window=0, lo=None):
    """The wrapper on each of n blocks, combined by log-sum-exp."""
    R = k.shape[1] // n
    parts = [ops.decode_attention_block(
        q, k[:, i * R:(i + 1) * R].contiguous(),
        v[:, i * R:(i + 1) * R].contiguous(), cur, window=window,
        offset=i * R, lo=lo) for i in range(n)]
    return parts, lse_combine(torch.stack([p[0] for p in parts]),
                              torch.stack([p[1] for p in parts]))


# (B, S, H, KV, D), cur_len: MHA, GQA (G = 4, 8), MQA; rows whose valid
# range leaves whole blocks empty
BLOCK_SHAPES = [((3, 48, 4, 4, 32), [48, 17, 5]),
                ((2, 96, 8, 2, 64), [96, 40]),
                ((2, 48, 8, 1, 32), [9, 48])]


@pytest.mark.parametrize("shape,cur", BLOCK_SHAPES)
@pytest.mark.parametrize("window", [0, 8, 24])
@pytest.mark.parametrize("n", [2, 3, 8])
def test_block_variant_splits_and_combines(shape, cur, window, n):
    """n blocks, each at its global offset, combined: within 1e-6 of
    the whole cache's attention; a block with no valid row gives o = 0
    and lse = -inf, and no NaN anywhere."""
    q, k, v = _inputs(*shape)
    cur = torch.tensor(cur, dtype=torch.int32)
    parts, got = _blocks(q, k, v, cur, n, window)
    want = decode_attention_ref(q, k, v, cur, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6
    R = shape[1] // n
    for i, (o, lse) in enumerate(parts):
        assert o.dtype == lse.dtype == torch.float32
        assert lse.shape == (shape[0], shape[2])
        assert not torch.isnan(o).any() and not torch.isnan(lse).any()
        first = torch.clamp(cur - window, min=0) if window else 0 * cur
        empty = (cur <= i * R) | (first >= (i + 1) * R)
        assert torch.equal(torch.isinf(lse).all(1), empty)
        assert (o[empty] == 0).all()


def test_block_variant_with_a_first_position():
    """``lo`` raises each row's first valid position (the slice-reads
    window): blocks combined equal the whole cache's attention over
    [max(lo, cur - window), cur)."""
    q, k, v = _inputs(3, 64, 8, 2, 32)
    cur = torch.tensor([60, 33, 20], dtype=torch.int32)
    lo = torch.tensor([50, 10, 18], dtype=torch.int32)
    _, got = _blocks(q, k, v, cur, 4, window=16, lo=lo)
    first = torch.maximum(cur - 16, lo)
    for b in range(3):
        want = decode_attention_ref(
            q[b:b + 1], k[b:b + 1, first[b]:], v[b:b + 1, first[b]:],
            cur[b:b + 1] - first[b])
        assert (got[b:b + 1] - want).abs().max() <= 1e-6


@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("shape", [(2, 256, 8, 2, 64), (2, 256, 4, 4, 80)])
def test_block_variant_matches_pallas(shape, window):
    """Four blocks combined, against the reference's Pallas kernel over
    the whole cache (interpret mode), float32, at 2e-5."""
    q, k, v = _inputs(*shape, seed=7)
    cur = torch.tensor([256, 150], dtype=torch.int32)
    _, got = _blocks(q, k, v, cur, 4, window)
    want = decode_attention_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(v.numpy()), jnp.asarray(cur.numpy()), window=window,
        bs=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_block_wrapper_checks_and_cost():
    """A negative offset raises; the plain version is what the CPU
    wrapper returns; ``cost_block`` counts only the block's valid rows
    (bytes and operations), every row of the block within the window
    when cur_len is not known (meta)."""
    q, k, v = _inputs(2, 64, 8, 2, 32)
    cur = torch.tensor([40, 64], dtype=torch.int32)
    with pytest.raises(ValueError, match="offset"):
        ops.decode_attention_block(q, k, v, cur, offset=-1)
    got = ops.decode_attention_block(q, k, v, cur, window=16, offset=32)
    want = decode_attention_block_ref(q, k, v, cur, window=16, offset=32)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # rows [32, 96) of a 96-row cache: row 0 keeps [32, 40), row 1 [48, 64)
    c = ops.cost_block(q, k, v, cur, window=16, offset=32)
    assert c.flops == 4 * 32 * 8 * (8 + 16)
    assert c.bytes == (q.numel() * 4 + 4 * 2 + 4 * 2 * 8 * 33
                       + 2 * (8 + 16) * 2 * 32 * 4)
    meta = ops.cost_block(q, k, v, torch.empty(2, device="meta"), window=16)
    assert meta.flops == 4 * 32 * 8 * 2 * 16


# ---------------------------------------------------------------------------
# Writes into each rank's rows, and the specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [(26, 30, 20, 28), (0, 5, 34, 35),
                                 (-3, -36, 40, -40)])
@pytest.mark.parametrize("n", [1, 4, 36])
@pytest.mark.parametrize("blocks", [2, 3])
def test_block_writes_equal_the_whole_write(pos, n, blocks):
    """Each block written with ``block`` (its offset, the cache's
    length): together ``==`` the write into the whole cache, the
    reference's drop semantics (negative and out-of-range positions)
    applied to the global position; int8 scales with their values; the
    uniform write at pos[0], clamped as a dynamic update slice."""
    B, S = 4, 36
    rng = np.random.default_rng(n + blocks)
    pos = torch.tensor(pos, dtype=torch.int32)
    buf = {"q": torch.tensor(rng.integers(-9, 9, (B, S, 2, 8)),
                             dtype=torch.int8),
           "s": torch.tensor(rng.random((B, S, 2)), dtype=torch.float32)}
    new = torch.tensor(rng.standard_normal((B, n, 2, 8)), dtype=torch.float32)
    R = S // blocks
    for uniform in (False, True):
        if uniform and n == S:
            continue
        want = kv_cache.clone(buf)
        kv_cache.write_layer(want, (), new, pos, uniform=uniform)
        got = kv_cache.clone(buf)
        for i in range(blocks):
            part = {k: t[:, i * R:(i + 1) * R] for k, t in got.items()}
            for key, val in zip(("q", "s"), kv_cache.quantize(new)):
                kv_cache._write_layer_arr(part[key], val, pos, uniform,
                                          None, (i * R, S))
        assert all(torch.equal(got[k], want[k]) for k in buf), uniform


def test_batch_and_kv_seq_on_one_axis_raise():
    """``cache_pspecs`` refuses rules that put the batch and the cache's
    sequence on one mesh axis, naming both; with the batch dropped (B =
    1) the sequence sits on data."""
    from repro_torch import config as tcfg
    cfg = tcfg.get_config("tinyllama-1.1b")
    run = tcfg.RunConfig(shard_kv_seq=True)
    rules = tcfg.sharding_rules_for(cfg, {"data": 16, "model": 16}, run)
    with pytest.raises(ValueError, match="batch.*kv_seq"):
        shd.cache_pspecs(cfg, run, rules)
    rules["batch"] = None
    specs = shd.cache_pspecs(cfg, run, rules)
    assert tuple(specs["k"]) == (None, None, "data", None, None)
