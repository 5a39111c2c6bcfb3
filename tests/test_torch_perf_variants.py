"""The serving knobs of ``RunConfig`` in the port, the counterpart of
tests/test_perf_variants.py, and each knob against the reference run
with the same knob:

  * ``decode_inplace_cache``: the in-place decode equals the default
    one (tinyllama, deepseek, zamba2, whisper, the VLM), and equals the
    reference's in-place decode on every family;
  * ``decode_slice_reads`` with ``decode_window``: the window's slice
    equals the masked full read while the rows share a position;
  * each of ``decode_inplace_cache``, ``decode_uniform_pos``,
    ``decode_slice_reads`` (with and without the in-place branch) and
    ``prefill_parallel_q`` equals the reference with the same knob, with
    float32, bfloat16 and int8 caches;
  * rows at different positions, where ``decode_uniform_pos`` writes a
    row at another row's position and ``decode_slice_reads`` drops the
    keys of the row ahead: the port reproduces the reference's contract;
  * ``layers.decode_attention_with_new`` against the reference's on the
    same inputs.

The reference runs with REPRO_FORCE_PALLAS=1 (its Pallas kernels in
interpret mode, which keep p in float32 as the port's kernels do); its
in-place branch is jnp either way, as the port's is plain torch.  Both
trees carry params drawn from one numpy seed in the reference's
structure (normal(0, 0.05), norm scales 1 + normal(0, 0.1), the VLM's
gates uniform in [0.5, 1]) and the same drawn modality inputs: at the
reference's init every softmax is one-hot (tests/test_torch_dense_
configs.py).  Tolerances, relative to the largest |logit|: 1e-4 with a
float32 cache (float32 sums in another order); 2e-2 with bfloat16 and
int8 caches (a cached k or v may round to the neighbouring bf16 value,
or its int8 code to the neighbouring one).  The port's in-place decode
against its own default one: the reference test's 2e-4.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import config as jcfg  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import kv_cache as jkv  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch import config  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.models import api, kv_cache, layers  # noqa: E402
from repro_torch.models.params import params_from_numpy  # noqa: E402

B, S, STEPS, WINDOW = 2, 12, 3, 4
MAX_LEN = S + STEPS + 1
TOL = {"float32": 1e-4, "bfloat16": 2e-2, "int8": 2e-2}
ARCHS = ["tinyllama-1.1b", "deepseek-moe-16b", "zamba2-2.7b",
         "whisper-tiny", "llama-3.2-vision-90b"]
KNOBS = {
    "inplace": dict(decode_inplace_cache=True),
    "inplace_uniform": dict(decode_inplace_cache=True,
                            decode_uniform_pos=True),
    "slice": dict(decode_window=WINDOW, decode_slice_reads=True),
    "inplace_slice": dict(decode_inplace_cache=True, decode_window=WINDOW,
                          decode_slice_reads=True),
    "parallel_q": dict(prefill_parallel_q=True)}
GQA = dict(num_kv_heads=2)           # tinyllama's smoke at G = 2


def _drawn(tree, seed):
    rng = np.random.default_rng(seed)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        if "gate" in str(path[-1]):
            return rng.uniform(0.5, 1.0, a.shape).astype(np.float32)
        if np.all(a == 1):
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return (0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, tree)


class _Model:
    def __init__(self, arch, **over):
        self.cfg = dataclasses.replace(
            config.smoke_variant(config.get_config(arch)), **over)
        self.jcfg = dataclasses.replace(
            jcfg.smoke_variant(jcfg.get_config(arch)), **over)
        tree = _drawn(jax.tree_util.tree_map(np.asarray, jax_api.init_model(
            self.jcfg, jax.random.PRNGKey(0))), 0)
        self.jp = jax.tree_util.tree_map(jnp.asarray, tree)
        self.params = params_from_numpy(
            api.get_model(self.cfg).schema(self.cfg), tree, "cpu")
        rng = np.random.default_rng(1)
        self.toks = rng.integers(0, self.cfg.vocab_size,
                                 (B, S)).astype(np.int32)
        M = self.cfg.num_audio_frames or self.cfg.num_vision_tokens
        self.key = ("audio_frames" if self.cfg.family == "audio"
                    else "vision_embeds")
        self.memory = rng.standard_normal(
            (B, M, self.cfg.d_model)).astype(np.float32) if M else None

    def extras(self):
        return None if self.memory is None \
            else {self.key: torch.tensor(self.memory)}

    def jextras(self):
        return None if self.memory is None \
            else {self.key: jnp.asarray(self.memory)}


_MODELS = {}


def _model(arch, **over):
    key = (arch, tuple(sorted(over.items())))
    if key not in _MODELS:
        _MODELS[key] = _Model(arch, **over)
    return _MODELS[key]


def _ref(m, kv_dtype, knobs, pos=None):
    """The reference's prefill and STEPS greedy decode steps (the first
    re-feeds the prompt's last token), Pallas forced; ``pos`` replaces
    the cache's positions after the prefill.  (prefill logits, [step
    logits], [tokens], last cache)."""
    run = jcfg.RunConfig(kv_cache_dtype=kv_dtype, **knobs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_FORCE_PALLAS", "1")
        pl, cache = jax_api.make_prefill_step(m.jcfg, run, MAX_LEN)(
            m.jp, jnp.asarray(m.toks), m.jextras())
        if pos is not None:
            cache = dict(cache, pos=jnp.asarray(pos, jnp.int32))
        step = jax_api.make_decode_step(m.jcfg, run)
        tok, logits, toks = jnp.asarray(m.toks[:, -1:]), [], []
        for _ in range(STEPS):
            lg, cache = step(m.jp, tok, cache, m.jextras())
            logits.append(np.asarray(lg[:, -1], np.float32))
            tok = jnp.argmax(lg[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok[:, 0]))
    return np.asarray(pl, np.float32), logits, toks, cache


def _port(m, kv_dtype, knobs, pos=None):
    run = config.RunConfig(kv_cache_dtype=kv_dtype, **knobs)
    pl, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(
        m.params, torch.tensor(m.toks, dtype=torch.int64), m.extras())
    if pos is not None:
        cache = dict(cache, pos=torch.tensor(pos, dtype=torch.int32))
    step = api.make_decode_step(m.cfg, run)
    tok, logits, toks = torch.tensor(m.toks[:, -1:], dtype=torch.int64), \
        [], []
    for _ in range(STEPS):
        lg, cache = step(m.params, tok, cache, m.extras())
        logits.append(lg[:, -1].float().numpy())
        tok = lg[:, -1].argmax(-1)[:, None]
        toks.append(tok[:, 0].numpy())
    return pl.float().numpy(), logits, toks, cache


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _np_cache(c):
    if isinstance(c, dict):
        return {k: _np_cache(v) for k, v in c.items()}
    if isinstance(c, torch.Tensor):
        return c.float().numpy()
    return np.asarray(jnp.asarray(c, jnp.float32)
                      if c.dtype == jnp.bfloat16 else c, np.float32)


def _match(got, want, tol, caches=True):
    (pl, logits, toks, cache), (jpl, jlogits, jtoks, jcache) = got, want
    _close(pl, jpl, tol)
    for a, b in zip(logits, jlogits):
        _close(a, b, tol)
    for a, b in zip(toks, jtoks):
        np.testing.assert_array_equal(a, b)
    if caches:
        for name in ("k", "v"):
            g, w = _np_cache(cache[name]), _np_cache(jcache[name])
            if isinstance(w, dict):      # int8: the dequantized entries
                g = g["q"] * g["s"][..., None]
                w = w["q"] * w["s"][..., None]
            _close(g, w, tol)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_inplace_cache_matches_baseline(arch):
    """The port's in-place decode against its default decode (the
    reference test's check, at its 2e-4), launching no decode kernel
    for self attention (on the CPU, none at all)."""
    m = _model(arch)
    base = _port(m, "float32", {})
    before = dec_ops.launches
    opt = _port(m, "float32", KNOBS["inplace"])
    assert dec_ops.launches == before
    for a, b in zip(opt[1], base[1]):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
    assert [list(t) for t in opt[2]] == [list(t) for t in base[2]]


@pytest.mark.parametrize("arch", ARCHS)
def test_inplace_cache_matches_reference(arch):
    m = _model(arch)
    _match(_port(m, "float32", KNOBS["inplace"]),
           _ref(m, "float32", KNOBS["inplace"]), TOL["float32"])


@pytest.mark.parametrize("arch,inplace", [("tinyllama-1.1b", True),
                                          ("tinyllama-1.1b", False),
                                          ("whisper-tiny", True)])
def test_slice_reads_match_masked_window(arch, inplace):
    """Rows at one position: the window's slice holds every key the
    masked read sees."""
    m = _model(arch)
    base = dict(decode_window=WINDOW, decode_inplace_cache=inplace)
    masked = _port(m, "float32", base)
    sliced = _port(m, "float32", dict(base, decode_slice_reads=True))
    for a, b in zip(sliced[1], masked[1]):
        np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("knob", list(KNOBS))
def test_knob_matches_reference(knob, kv_dtype):
    m = _model("tinyllama-1.1b", **GQA)
    _match(_port(m, kv_dtype, KNOBS[knob]), _ref(m, kv_dtype, KNOBS[knob]),
           TOL[kv_dtype])


# positions after the prefill: row 0 two ahead of row 1.  With the
# window of 4, row 0 keeps 2 of its keys in the batch's slice (its new
# token's included only on the in-place branch, out of band)
POS = [S - 5, S - 7]


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("knob", ["inplace_uniform", "slice",
                                  "inplace_slice"])
def test_rows_at_different_positions_match_reference(knob, kv_dtype):
    m = _model("tinyllama-1.1b", **GQA)
    got = _port(m, kv_dtype, KNOBS[knob], pos=POS)
    _match(got, _ref(m, kv_dtype, KNOBS[knob], pos=POS), TOL[kv_dtype])
    if knob == "slice":
        # row 0 lost keys: it differs from the masked full read
        masked = _port(m, kv_dtype, dict(decode_window=WINDOW), pos=POS)
        assert np.abs(got[1][0][0] - masked[1][0][0]).max() > 1e-3
        np.testing.assert_allclose(got[1][0][1], masked[1][0][1],
                                   atol=1e-5, rtol=1e-5)


def test_uniform_pos_writes_every_row_at_the_first_rows_position():
    """decode_uniform_pos with rows at different positions: after a
    step, row 1's k sits at row 0's position, and its own slot is as
    the prefill left it (the reference's contract)."""
    m = _model("tinyllama-1.1b", **GQA)
    run = config.RunConfig(kv_cache_dtype="float32", **KNOBS["inplace_uniform"])
    _, cache = api.make_prefill_step(m.cfg, run, MAX_LEN)(
        m.params, torch.tensor(m.toks, dtype=torch.int64))
    cache = dict(cache, pos=torch.tensor(POS, dtype=torch.int32))
    before = cache["k"].clone()
    _, after = api.make_decode_step(m.cfg, run)(
        m.params, torch.tensor(m.toks[:, -1:], dtype=torch.int64), cache)
    k = after["k"]
    assert k is cache["k"]                     # written in place
    assert torch.equal(k[:, 1, POS[1]], before[:, 1, POS[1]])
    assert not torch.equal(k[:, 1, POS[0]], before[:, 1, POS[0]])


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_with_new_matches_reference(kv_dtype, window):
    rng = np.random.default_rng(4)
    Bq, Sc, H, KV, D = 3, 16, 8, 2, 32
    q = rng.standard_normal((Bq, 1, H, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((Bq, Sc, KV, D)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.standard_normal((Bq, 1, KV, D)).astype(np.float32)
              for _ in range(2))
    cur = np.array([3, 9, 16], np.int32)
    zero = np.zeros(Bq, np.int32)
    jk, jv = (jkv.write(jkv.alloc(Bq, Sc, KV, D, kv_dtype), jnp.asarray(a),
                        jnp.asarray(zero)) for a in (kc, vc))
    tk, tv = (kv_cache.write(kv_cache.alloc(Bq, Sc, KV, D, kv_dtype, "cpu"),
                             torch.tensor(a), torch.tensor(zero))
              for a in (kc, vc))
    want = jax_layers.decode_attention_with_new(
        jnp.asarray(q), jkv.read(jk), jkv.read(jv), jnp.asarray(kn),
        jnp.asarray(vn), jnp.asarray(cur), window=window)
    got = layers.decode_attention_with_new(
        torch.tensor(q), kv_cache.read(tk), kv_cache.read(tv),
        torch.tensor(kn), torch.tensor(vn), torch.tensor(cur),
        window=window)
    assert got.dtype == torch.float32 and got.shape == (Bq, 1, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
