"""The port's dry run (``repro_torch.launch.dryrun`` and
``launch.trace_cost``) against the reference's (``repro.launch.dryrun``
and ``launch.hlo_cost``), and each kernel's ``cost`` against the bounds
PERF.md prints.

``repro.launch.dryrun`` sets 512 host devices for jax in its first
lines, so it is imported only in a child process; everything else runs
here on the CPU, the port's steps on the meta device.  The ``--all``
sweep runs at smoke width; xLSTM's sLSTM is a Python loop over the
sequence (one step at a time, as the reference's ``lax.scan``), so its
trace grows with S, and the sweep shortens xLSTM's shapes to S = 64
(decode shapes keep theirs: one step).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import SHAPES as JAX_SHAPES  # noqa: E402
from repro.config import RunConfig as JaxRun  # noqa: E402
from repro.config import get_config as jax_config  # noqa: E402
from repro.config import smoke_variant as jax_smoke  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro_torch.config import (SHAPES, ShapeConfig, get_config,  # noqa: E402
                                list_archs, smoke_variant)
from repro_torch.kernels import (BF16_OPS_PER_S, F32_OPS_PER_S,  # noqa: E402
                                 HBM_BYTES, NODE_LINK_BYTES_PER_S,
                                 NVLINK_BYTES_PER_S, TF32_OPS_PER_S,
                                 KernelCost)
from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.groupnorm_silu import ops as gn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.trace_cost import TraceCost  # noqa: E402
from repro_torch.models import api  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

ARCHS = [a for a in list_archs() if a != "ddim-cifar10"]
XLSTM_S = 64          # xLSTM's shortened train and prefill length


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _sig(tree):
    """(path, shape, type) of every leaf, torch or jax."""
    return [(jax.tree_util.keystr(p), tuple(x.shape),
             str(x.dtype).replace("torch.", ""))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


# -- shapes, run configs, abstract inputs -------------------------------------

def test_shapes_equal_the_reference():
    assert list(SHAPES) == list(JAX_SHAPES)
    for name, shape in SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(
            JAX_SHAPES[name])


_RUN_FOR = r"""
import dataclasses, json, sys
import repro.launch.dryrun as d          # sets 512 host devices first
from repro.config import SHAPES, get_config, list_archs
out = {}
for a in list_archs():
    if a == "ddim-cifar10":
        continue
    for s in SHAPES:
        for o in (False, True):
            out[f"{a}|{s}|{o}"] = dataclasses.asdict(
                d.run_for(get_config(a), SHAPES[s], opt=o))
json.dump(out, open(sys.argv[1], "w"))
"""


def test_run_for_is_the_references_on_one_card(tmp_path):
    """Every arch x shape x opt: the reference's ``run_for`` with fsdp
    and shard_kv_seq off.  Its slice-reads knob is ``decode_window and
    not shard_kv_seq``; with the cache unsharded that is the window
    alone."""
    path = tmp_path / "run_for.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _RUN_FOR, str(path)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(path.read_text())
    assert len(want) == len(ARCHS) * len(SHAPES) * 2
    for key, ref in want.items():
        arch, shape, opt = key.split("|")
        opt = opt == "True"
        ref = dict(ref, fsdp=False, shard_kv_seq=False,
                   decode_slice_reads=opt and bool(ref["decode_window"]))
        got = dryrun.run_for(get_config(arch), SHAPES[shape], opt=opt)
        assert dataclasses.asdict(got) == ref, key


_MESH_RULES = r"""
import dataclasses, json, sys, types
import repro.launch.dryrun as d          # sets 512 host devices first
from repro.config import SHAPES, get_config, list_archs
meshes = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
out = {}
for a in list_archs():
    if a == "ddim-cifar10":
        continue
    for s in SHAPES:
        for o in (False, True):
            run = d.run_for(get_config(a), SHAPES[s], opt=o)
            for m, (names, shape) in meshes.items():
                stub = types.SimpleNamespace(
                    axis_names=names,
                    devices=types.SimpleNamespace(shape=shape))
                rules = d.rules_for(get_config(a), SHAPES[s], run, stub, o)
                out[f"{a}|{s}|{o}|{m}"] = [
                    dataclasses.asdict(run),
                    {k: list(v) if isinstance(v, tuple) else v
                     for k, v in rules.items()}]
json.dump(out, open(sys.argv[1], "w"))
"""


def test_run_for_and_rules_for_are_the_references_at_the_meshes(tmp_path):
    """Every arch x shape x {16x16, 2x16x16} x opt: the mesh form of
    ``run_for`` (fsdp, shard_kv_seq at long_500k, slice reads only over
    an unsplit sequence) and ``rules_for`` (batch dropped at B = 1, seq
    on model for train, the --opt prefill seq and decode kv_seq on
    model) ``==`` the reference's, its meshes stubbed by their axis
    names and shape."""
    path = tmp_path / "mesh_rules.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _MESH_RULES, str(path)],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr
    want = json.loads(path.read_text())
    assert len(want) == len(ARCHS) * len(SHAPES) * 2 * 2
    sizes = {"16x16": {"data": 16, "model": 16},
             "2x16x16": {"pod": 2, "data": 16, "model": 16}}
    for key, (ref_run, ref_rules) in want.items():
        arch, shape, opt, mesh = key.split("|")
        opt = opt == "True"
        run = dryrun.run_for(get_config(arch), SHAPES[shape], opt=opt,
                             mesh=mesh)
        assert dataclasses.asdict(run) == ref_run, key
        rules = dryrun.rules_for(get_config(arch), SHAPES[shape], run,
                                 sizes[mesh], opt)
        assert {k: list(v) if isinstance(v, tuple) else v
                for k, v in rules.items()} == ref_rules, key


def _child(code: str, timeout: float = 240.0):
    """Run ``code`` in a child process (each starts its own fake process
    group) and return what it printed last, parsed as JSON."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_known_redistribution_counts_its_gathers():
    """On the 16 x 16 production mesh (a fake group of 256 ranks, rank
    0), a 4096 x 4096 float32 meta tensor placed [Shard(0), Shard(1)]
    (256 x 256 blocks) and redistributed to replicated: the counter sees
    two all-gathers, the first of the (256, 256) block over "model", the
    second of the gathered (256, 4096) rows over "data": 4 * 256 * 256 +
    4 * 256 * 4096 operand bytes, by hand.  A product of DTensors counts
    the rank's local product once: (256, 1024) rows of x (split on data)
    times a replicated (1024, 512) w, 2 * 256 * 1024 * 512 flops, and
    its local bytes, with no collective (DTensor's sharding propagation,
    on fake tensors, counts nothing)."""
    got = _child(r"""
import json, torch
from torch.distributed.tensor import distribute_tensor, Replicate, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.trace_cost import TraceCost
with dryrun.production_mesh("16x16") as mesh:
    groups = {mesh.get_group(i).group_name: n
              for i, n in enumerate(mesh.mesh_dim_names)}
    a = distribute_tensor(torch.empty(4096, 4096, device="meta"), mesh,
                          [Shard(0), Shard(1)])
    with TraceCost(groups) as tc:
        a.redistribute(mesh, [Replicate(), Replicate()])
    x = distribute_tensor(torch.empty(4096, 1024, device="meta"), mesh,
                          [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(1024, 512, device="meta"), mesh,
                          [Replicate(), Replicate()])
    with TraceCost(groups) as mm:
        y = x @ w
print(json.dumps([list(a.to_local().shape), tc.collectives,
                  mm.product_flops, mm.bytes, mm.collectives,
                  list(y.to_local().shape)]))
""")
    local, coll, flops, nbytes, mm_coll, out = got
    assert local == [256, 256]
    assert coll == {"all-gather": {
        "calls": 2, "bytes": 4 * 256 * 256 + 4 * 256 * 4096,
        "by_axis": {"model": 4 * 256 * 256, "data": 4 * 256 * 4096}}}
    assert out == [256, 512] and mm_coll == {}
    assert flops == 2 * 256 * 1024 * 512
    assert nbytes == 4 * (256 * 1024 + 1024 * 512 + 256 * 512)


_MESH_RECORD = r"""
import json, sys
from repro_torch.launch import dryrun
print(json.dumps(dryrun.analyze(sys.argv[1], sys.argv[2],
                                opt=sys.argv[3] == "opt", mesh=sys.argv[4])))
"""


def _mesh_record(arch, shape, opt, mesh):
    code = _MESH_RECORD.replace("sys.argv[1]", repr(arch)).replace(
        "sys.argv[2]", repr(shape)).replace(
        'sys.argv[3] == "opt"', repr(opt)).replace("sys.argv[4]", repr(mesh))
    return _child(code)


def test_long_500k_at_16x16_holds_a_sixteenth_of_the_cache():
    """TinyLlama at ``long_500k``, full width on meta, at 16 x 16: the
    cache's sequence is split on data (``shard_kv_seq``, the batch of 1
    dropped), so each card's k and v bytes are 1/16 of the one-card
    record's; the decode runs the block kernel, 22 calls, and combines
    by all-reduces; the record carries the reference's keys and the
    link rates it priced them at."""
    one = dryrun.analyze("tinyllama-1.1b", "long_500k")
    rec = _mesh_record("tinyllama-1.1b", "long_500k", False, "16x16")
    assert rec["mesh"] == "16x16" and rec["chips"] == 256
    assert rec["run"]["shard_kv_seq"] and rec["rules"]["kv_seq"] == ["data"]
    assert rec["rules"]["batch"] is None
    for key in ("cache/k", "cache/v"):
        assert 16 * rec["memory_analysis"]["argument_bytes_by_input"][key] \
            == one["memory_analysis"]["argument_bytes_by_input"][key]
    assert rec["kernels"]["decode_attention_block"]["calls"] == 22
    assert "decode_attention" not in rec["kernels"]
    assert set(rec["collectives"]["counts"]) >= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert rec["collective_bytes_per_chip"] == sum(
        rec["collectives"]["bytes"].values()) > 0
    rates = rec["roofline"]["link_rates"]
    assert {r["bytes_per_s"] for r in rates.values()} == {
        NODE_LINK_BYTES_PER_S}
    assert rec["roofline"]["collective_s"] == pytest.approx(
        rec["collective_bytes_per_chip"] / NODE_LINK_BYTES_PER_S)
    assert rec["fits_one_card"]


def test_decode_32k_opt_has_an_all_reduce_term():
    """TinyLlama ``decode_32k --opt`` at 16 x 16: its 4 KV heads do not
    split over the 16-wide model axis, so the cache's sequence goes
    there and the in-place decode joins the blocks by all-reduces over
    "model": a nonzero all-reduce term."""
    rec = _mesh_record("tinyllama-1.1b", "decode_32k", True, "16x16")
    assert rec["rules"]["kv_seq"] == ["model"]
    assert rec["rules"]["batch"] == ["data"]
    assert rec["collectives"]["counts"]["all-reduce"] > 0
    assert rec["collectives"]["bytes"]["all-reduce"] > 0
    assert rec["collectives"]["bytes_by_axis"]["model"] > 0
    assert rec["roofline"]["collective_s"] > 0


def test_link_rates_by_axis():
    """An axis whose group of rank 0 spans at most 8 consecutive ranks
    (one node) is priced at NVLink, a wider one at the node link."""
    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (32, 8)
    rates = dryrun.link_rates(Mesh())
    assert rates["model"]["bytes_per_s"] == NVLINK_BYTES_PER_S
    assert rates["data"]["bytes_per_s"] == NODE_LINK_BYTES_PER_S
    Mesh.shape = (16, 16)
    assert {r["bytes_per_s"] for r in dryrun.link_rates(Mesh()).values()} \
        == {NODE_LINK_BYTES_PER_S}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_model_and_input_specs_are_the_references(arch):
    """Full width, every shape: params and every step input on the meta
    device with the reference's ``ShapeDtypeStruct`` shapes and types
    (tokens int32, bfloat16 params, the decode cache of ``seq_len``
    rows from ``init_cache``)."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    params = api.abstract_model(cfg)
    assert all(t.is_meta for t in jax.tree_util.tree_leaves(params))
    assert _sig(params) == _sig(jax_api.abstract_model(jcfg))
    for name, shape in SHAPES.items():
        run = dryrun.run_for(cfg, shape)
        got = api.input_specs(cfg, shape, run)
        want = jax_api.input_specs(jcfg, JAX_SHAPES[name],
                                   JaxRun(**dataclasses.asdict(run)),
                                   abstract=True)
        assert all(t.is_meta for t in jax.tree_util.tree_leaves(got))
        assert _sig(got) == _sig(want), (arch, name)


# -- trace_cost against hand counts -------------------------------------------

def test_product_flops_are_2mnk_and_views_are_free():
    a, b = meta(64, 32), meta(32, 16)
    with TraceCost() as tc:
        c = a @ b
        c.reshape(-1)[:8].unsqueeze(0)
        c.t()[2:5]
        a.view(32, 64).transpose(0, 1)
    assert tc.product_flops == 2 * 64 * 32 * 16
    assert tc.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert tc.kernels == {}
    x = meta(4, 8, 16, dtype=torch.bfloat16)
    w = meta(4, 16, 8, dtype=torch.bfloat16)
    with TraceCost() as tc:
        torch.bmm(x, w)
    assert dict(tc.flops_by_type) == {torch.bfloat16: 2 * 4 * 8 * 16 * 8}


def test_a_loop_of_layers_counts_each_layer():
    x, w = meta(8, 32), meta(32, 32)

    def layer(h):
        return torch.tanh(h @ w) + h
    with TraceCost() as one:
        layer(x)
    with TraceCost() as four:
        h = x
        for _ in range(4):
            h = layer(h)
    assert one.product_flops == 2 * 8 * 32 * 32
    assert four.product_flops == 4 * one.product_flops
    assert four.bytes == 4 * one.bytes
    assert four.ops == 4 * one.ops


def test_a_slice_write_counts_the_slice():
    """The KV cache write of ``models/kv_cache.py`` (an index_put_ of B
    rows into a (B, S, KV, D) buffer) counts its indices and the values
    read and written, not the buffer; so does ``index_copy_``."""
    from repro_torch.models import kv_cache
    B, S, KV, D = 2, 1024, 4, 64
    buf = meta(B, S, KV, D, dtype=torch.bfloat16)
    new = meta(B, 1, KV, D, dtype=torch.bfloat16)
    idx = meta(1, dtype=torch.int64)
    with TraceCost() as tc:
        buf.index_copy_(1, idx, new)
    assert tc.bytes == 8 + 2 * B * KV * D * 2
    pos = torch.zeros(B, dtype=torch.int32, device="meta")
    rows, slots = kv_cache.write_index(pos, 1, S)[:2]
    with TraceCost() as tc:
        buf[rows, slots] = new
    assert tc.bytes == 2 * B * 8 + 2 * B * KV * D * 2
    assert tc.bytes < buf.nbytes / 100


def test_a_kernel_call_counts_once_with_its_cost():
    """Inside a wrapper's meta branch: one call at the kernel's cost and
    none of its plain version's ops (the plain attention's products, the
    rmsnorm's elementwise passes)."""
    q, k = meta(2, 128, 8, 64), meta(2, 128, 2, 64)
    x, s = meta(2, 128, 256), meta(256)
    with TraceCost() as tc:
        o = fa_ops.flash_attention(q, k, k)
        y = rms_ops.rmsnorm(x, s)
    assert (o.shape, o.dtype, o.is_meta) == (q.shape, q.dtype, True)
    assert (y.shape, y.is_meta) == (x.shape, True)
    fc, rc = fa_ops.cost(q, k, k), rms_ops.cost(x, s)
    assert tc.kernels == {
        "flash_attention": dict(calls=1, flops=fc.flops, bytes=fc.bytes,
                                seconds=fc.times_ms()[1] / 1e3),
        "rmsnorm": dict(calls=1, flops=rc.flops, bytes=rc.bytes,
                        seconds=rc.times_ms()[1] / 1e3)}
    assert tc.product_flops == 0 and tc.bytes == 0
    assert tc.flops == fc.flops + rc.flops
    assert tc.peak_bytes == o.nbytes + y.nbytes     # the outputs' memory
    assert fa_ops.launches == 0 and rms_ops.launches == 0


def test_a_kernel_backward_is_counted_op_by_op():
    """Under grad the meta branch runs through ``with_grad`` as the card
    does: one kernel call forward, the plain version's autograd (its
    products counted, the forward it recomputes among them) backward."""
    x = meta(4, 64).requires_grad_()
    s = meta(64).requires_grad_()
    with TraceCost() as tc:
        rms_ops.rmsnorm(x, s).sum().backward()
    assert tc.kernels["rmsnorm"]["calls"] == 1
    assert x.grad.shape == x.shape and s.grad.shape == s.shape
    assert tc.bytes > 0
    q = meta(1, 16, 2, 64).requires_grad_()
    with TraceCost() as tc:
        fa_ops.flash_attention(q, q, q).sum().backward()
    assert tc.kernels["flash_attention"]["calls"] == 1
    # the plain backward re-runs the forward (q.k and p.v), then takes
    # dq, dk, dp and dv: six products of 2 B H S S D each
    assert tc.product_flops == 6 * 2 * 1 * 2 * 16 * 16 * 64


def test_peak_live_bytes_on_known_allocations():
    with TraceCost() as tc:
        a = torch.empty(100, device="meta")                  # 400
        b = torch.empty(200, device="meta")                  # 1200
        del a                                                # 800
        c = torch.empty(50, device="meta")                   # 1000
        d = b.view(20, 10)                                   # a view: 1000
        e = torch.exp(d)                                     # 1800
        del b, d                                             # 1000
        f = torch.empty(150, device="meta")                  # 1600
    assert tc.peak_bytes == 1800
    assert tc.live_bytes == 1600
    del c, e, f
    assert tc.live_bytes == 0
    x = meta(10, 10)
    with TraceCost() as tc:
        x.add_(1.0)                                          # in place
    assert tc.peak_bytes == 0 and tc.bytes == 2 * 400


def test_the_memo_of_layouts_keeps_what_the_op_gives():
    """A meta op run again at the same layout gets new empty tensors of
    the first run's shape, strides and type; CPU tensors always run."""
    x = meta(4, 6).t()
    with TraceCost() as tc:
        outs = [torch.exp(x) for _ in range(3)]
        c = torch.ones(3) * 2
    want = torch.exp(torch.empty(4, 6).t())
    for o in outs:
        assert (o.shape, o.stride(), o.dtype, o.is_meta) == (
            want.shape, want.stride(), want.dtype, True)
    assert len({id(o.untyped_storage()) for o in outs}) == 3
    assert c.tolist() == [2.0, 2.0, 2.0]
    assert tc.ops == 5


# -- the port's product flops against hlo_cost's ------------------------------

def _ref_flops(fn, *args):
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_product_flops_within_1pct_of_hlo_cost(kind):
    """Smoke TinyLlama: the trace's products outside kernel calls
    against ``analyze_hlo`` on the reference's compiled step (jnp mode,
    as ``tests/test_system.py`` compiles it), less its own attention
    (``analyze_hlo`` of ``chunked_attention`` or ``decode_attention``
    alone at the step's shapes, times the layers): the attention is a
    kernel call in the port."""
    B, S = 2, 128
    cfg, jcfg = smoke_variant(get_config("tinyllama-1.1b")), \
        jax_smoke(jax_config("tinyllama-1.1b"))
    rec = dryrun.analyze("tinyllama-1.1b", ShapeConfig(kind, S, B, kind),
                         smoke=True)
    run = JaxRun()
    params = jax_api.abstract_model(jcfg)
    H, KV, D = jcfg.num_heads, jcfg.num_kv_heads, jcfg.resolved_head_dim
    sds = jax.ShapeDtypeStruct
    if kind == "prefill":
        step = jax_api.make_prefill_step(jcfg, run, max_len=S)
        total = _ref_flops(step, params, sds((B, S), jnp.int32))
        attn = _ref_flops(
            lambda q, k, v: jax_layers.chunked_attention(q, k, v,
                                                         causal=True),
            sds((B, S, H, D), jnp.bfloat16), sds((B, S, KV, D), jnp.bfloat16),
            sds((B, S, KV, D), jnp.bfloat16))
    else:
        step = jax_api.make_decode_step(jcfg, run)
        cache = jax_api.get_model(jcfg).init_cache(jcfg, B, S, run,
                                                   abstract=True)
        total = _ref_flops(step, params, sds((B, 1), jnp.int32), cache)
        attn = _ref_flops(
            lambda q, k, v, n: jax_layers.decode_attention(q, k, v, n),
            sds((B, 1, H, D), jnp.bfloat16), sds((B, S, KV, D), jnp.bfloat16),
            sds((B, S, KV, D), jnp.bfloat16), sds((B,), jnp.int32))
    want = total - cfg.num_layers * attn
    assert rec["kernels"]["flash_attention" if kind == "prefill"
                          else "decode_attention"]["calls"] == cfg.num_layers
    assert abs(rec["product_flops"] - want) <= 0.01 * want, \
        (rec["product_flops"], want)


# -- the sweep at smoke width -------------------------------------------------

def _shapes(arch):
    if arch != "xlstm-125m":
        return list(SHAPES.values())
    return [dataclasses.replace(s, seq_len=XLSTM_S) if s.kind != "decode"
            else s for s in SHAPES.values()]


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """``dryrun.sweep`` at smoke width, base and ``--opt``, into a temp
    directory: {(arch, shape, opt): record}."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    lines = []
    for opt in (False, True):
        for arch in ARCHS:
            failures = dryrun.sweep([arch], _shapes(arch), opt, str(out),
                                    smoke=True, echo=lines.append)
            assert not failures, failures
    recs = {}
    for f in sorted(out.glob("*.json")):
        rec = json.loads(f.read_text())
        recs[rec["arch"], rec["shape"], rec["opt"]] = (f.name, rec)
    return recs, lines


@pytest.mark.parametrize("opt", [False, True])
def test_sweep_writes_one_well_formed_record_each(sweep, opt):
    recs, lines = sweep
    mine = {k: v for k, v in recs.items() if k[2] == opt}
    assert set(mine) == {(a, s, opt) for a in ARCHS for s in SHAPES}
    assert len(lines) == 2 * len(ARCHS) * len(SHAPES)
    for (arch, shape, _), (name, rec) in mine.items():
        assert name == f"{arch}_{shape}{'_opt' if opt else ''}.json"
        assert rec["hlo_flops_per_chip"] > 0 and rec["hlo_bytes_per_chip"] > 0
        assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
        assert rec["chips"] == 1 and rec["mesh"] == "1xH100"
        assert rec["kind"] == SHAPES[shape].kind
        mem = rec["memory_analysis"]
        assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
        assert rec["fits_one_card"] in (True, False)
        assert rec["model_flops_total"] > 0 and rec["trace_seconds"] > 0
        assert rec["useful_flops_ratio"] == pytest.approx(
            rec["model_flops_total"] / rec["hlo_flops_per_chip"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_kernel_calls_are_expected_launches(sweep, arch):
    """Each record's kernel calls equal ``chip_smoke.expected_launches``
    for its config, run (remat, serving knobs) and step."""
    recs, _ = sweep
    cfg = smoke_variant(get_config(arch))
    for shape in SHAPES.values():
        for opt in (False, True):
            _, rec = recs[arch, shape.name, opt]
            run = dryrun.run_for(cfg, shape, opt)
            n = {"train": dict(train_steps=1), "prefill": dict(prefills=1),
                 "decode": dict(decodes=1)}[shape.kind]
            want = chip_smoke.expected_launches(
                cfg, n.get("prefills", 0), n.get("decodes", 0), run,
                train_steps=n.get("train_steps", 0))
            got = {k: rec["kernels"].get(k, {}).get("calls", 0)
                   for k in want}
            assert got == want, (arch, shape.name, opt)


def test_prefill_cache_matches_the_decode_spec():
    """What phase dryrun's card check gates, on the CPU at smoke width:
    a real prefill's cache, fed to the decode step, has the bytes of
    ``input_specs``' decode cache, so the trace's argument bytes are
    the card's."""
    cfg = smoke_variant(get_config("zamba2-2.7b"))
    shape = ShapeConfig("decode", 64, 2, "decode")
    run = dryrun.run_for(cfg, shape)
    params = api.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                            torch.bfloat16)
    toks = torch.zeros((2, 32), dtype=torch.int32)
    _, cache = api.make_prefill_step(cfg, run, 64)(params, toks)
    spec = api.input_specs(cfg, shape, run)
    assert _sig(cache) == _sig(spec["cache"])
    rec = dryrun.analyze("zamba2-2.7b", shape, smoke=True)
    assert rec["memory_analysis"]["argument_bytes"] == dryrun.tree_bytes(
        params, {"token": toks[:, -1:], "cache": cache})


# -- each kernel's cost, held to PERF.md section 6 ----------------------------

def _ms(calls_and_costs):
    return sum(n * c.ms for n, c in calls_and_costs)


def test_flash_cost_is_perf_md_tinyllama_row():
    """22 causal calls a prefill at q (8,128,32,64), k, v (8,128,4,64)
    f32: 0.1240 ms (bytes)."""
    q, k = meta(8, 128, 32, 64), meta(8, 128, 4, 64)
    c = fa_ops.cost(q, k, k)
    assert f"{_ms([(22, c)]):.4f}" == "0.1240" and c.bound_by == "bytes"
    assert c.flops == 4 * 64 * (128 * 129 // 2) * 8 * 32
    assert fa_ops.pairs(128, 128) == 128 * 129 // 2
    assert fa_ops.pairs(4, 10, causal=False) == 40
    assert fa_ops.pairs(3, 8, window=2) == 6
    assert fa_ops.pairs(2, 8, q_offset=0) == 3


def test_rmsnorm_cost_is_perf_md_tinyllama_row():
    """45 calls a forward at (8,128,2048) in the prefill and at
    (8,1,2048) in the decode step, f32: 0.2273 ms (bytes)."""
    w = meta(2048)
    got = _ms([(45, rms_ops.cost(meta(8, 128, 2048), w)),
               (45, rms_ops.cost(meta(8, 1, 2048), w))])
    assert f"{got:.4f}" == "0.2273"
    assert rms_ops.cost(meta(8, 1, 2048), w).flops == 4 * 8 * 2048


def test_ssd_scan_cost_is_perf_md_zamba2_row():
    """54 calls a prefill at x (8,128,80,64), B, C (8,128,64), h0
    (8,80,64,64) f32, chunk 128: 1.0279 ms (bytes)."""
    x = meta(8, 128, 80, 64)
    bc = meta(8, 128, 64)
    c = ssd_ops.cost(x, meta(8, 128, 80), bc, bc, meta(8, 80, 64, 64))
    assert f"{_ms([(54, c)]):.4f}" == "1.0279" and c.bound_by == "bytes"


def test_groupnorm_silu_cost_is_perf_md_row_at_b16():
    """45 calls a U-Net forward at B=16, f32: 0.1160 ms (bytes); the
    per-forward shapes are ``chip_smoke.gn_shapes``' (H, W, C) counts."""
    shapes = {(32, 32, 128): 8, (16, 16, 128): 1, (16, 16, 256): 6,
              (8, 8, 256): 7, (4, 4, 256): 11, (4, 4, 512): 3,
              (8, 8, 512): 3, (16, 16, 512): 2, (16, 16, 384): 1,
              (32, 32, 384): 1, (32, 32, 256): 2}
    assert sum(shapes.values()) == 45
    got = _ms([(n, gn_ops.cost(meta(16, H, W, C), meta(C), meta(C), 32))
               for (H, W, C), n in shapes.items()])
    assert f"{got:.4f}" == "0.1160"


def test_decode_cost_is_perf_md_tinyllama_row():
    """22 calls a decode step at q (8,1,32,64) f32 over a (8,512,4,64)
    bfloat16 cache: 0.0154 ms (bytes).  The bound reads this call's
    cur_len, drawn by chip_smoke.py's timing row (numpy seed 21, after
    the checks) and recorded with the row in chip_smoke.json."""
    q, kc = meta(8, 1, 32, 64), meta(8, 512, 4, 64, dtype=torch.bfloat16)
    cur = torch.tensor([333, 390, 460, 311, 327, 221, 28, 98],
                       dtype=torch.int32)
    c = dec_ops.cost(q, kc, kc, cur)
    assert f"{_ms([(22, c)]):.4f}" == "0.0154" and c.bound_by == "bytes"
    assert c.bytes == 2351136


def test_decode_cost_counts_the_rows_read():
    """One call at q (8,1,32,64) f32 over a (8,512,4,64) bfloat16 cache:
    the rows of each cur_len read once (every row whole on the meta
    device), 4 D operations per row read and head."""
    q, kc = meta(8, 1, 32, 64), meta(8, 512, 4, 64, dtype=torch.bfloat16)
    full = dec_ops.cost(q, kc, kc)
    assert full == dec_ops.cost(q, kc, kc, torch.full((8,), 512,
                                                      device="meta"))
    cur = torch.tensor([1, 512, 600, 3, 100, 7, 256, 9])
    c = dec_ops.cost(q, kc, kc, cur)
    valid = 1 + 512 + 512 + 3 + 100 + 7 + 256 + 9
    assert c == KernelCost(4 * 64 * 32 * valid,
                           2 * q.nbytes + 4 * 8 + 2 * valid * 4 * 64 * 2)
    assert full.bytes == 2 * q.nbytes + 32 + 2 * 8 * 512 * 4 * 64 * 2
    assert dec_ops.cost(q, kc, kc, cur, window=64).flops == \
        4 * 64 * 32 * (1 + 64 + 64 + 3 + 64 + 7 + 64 + 9)


def test_costs_take_the_rate_of_their_operands_type():
    """A bfloat16 flash or decode call's operations run at the bfloat16
    tensor-core rate, one operation each; float32 flash at 3xTF32, a
    decode with a float32 operand at the float32 rate; ssd_scan's state
    is float32 at every type.  Under the trace counter a kernel call's
    seconds are its cost's operations term at that rate."""
    bf16 = torch.bfloat16
    q, k = meta(8, 512, 32, 64), meta(8, 512, 4, 64)
    qb, kb = meta(8, 512, 32, 64, dtype=bf16), meta(8, 512, 4, 64, dtype=bf16)
    f, b = fa_ops.cost(q, k, k), fa_ops.cost(qb, kb, kb)
    assert f.flops == b.flops == 4 * 64 * (512 * 513 // 2) * 8 * 32
    assert (f.ops_per_s, f.per_op) == (TF32_OPS_PER_S, 3)
    assert (b.ops_per_s, b.per_op) == (BF16_OPS_PER_S, 1)
    assert 2 * b.bytes == f.bytes
    assert b.times_ms()[1] == pytest.approx(
        f.times_ms()[1] * TF32_OPS_PER_S / (3 * BF16_OPS_PER_S))
    with TraceCost() as tc:
        fa_ops.flash_attention(qb, kb, kb)
    assert tc.kernels["flash_attention"]["seconds"] == b.times_ms()[1] / 1e3
    assert tc.compute_s == b.times_ms()[1] / 1e3

    dq, dqb = meta(8, 1, 32, 64), meta(8, 1, 32, 64, dtype=bf16)
    cache = meta(8, 1024, 4, 64, dtype=bf16)
    mixed, both = dec_ops.cost(dq, cache, cache), dec_ops.cost(dqb, cache,
                                                                cache)
    assert (mixed.ops_per_s, mixed.per_op) == (F32_OPS_PER_S, 1)
    assert (both.ops_per_s, both.per_op) == (BF16_OPS_PER_S, 1)
    assert mixed.flops == both.flops

    xb, bcb = meta(8, 128, 80, 64, dtype=bf16), meta(8, 128, 64, dtype=bf16)
    s = ssd_ops.cost(xb, meta(8, 128, 80), bcb, bcb, meta(8, 80, 64, 64))
    assert (s.ops_per_s, s.per_op) == (TF32_OPS_PER_S, 3)
    assert HBM_BYTES == 80 * 2**30


def test_chip_smoke_bounds_call_the_costs():
    """``chip_smoke``'s bound functions are thin calls of the wrappers'
    ``cost``, with their old signatures (tools/ call them)."""
    q, k = meta(8, 128, 32, 64), meta(8, 128, 4, 64)
    c = fa_ops.cost(q, k, k)
    assert chip_smoke.flash_bound(q, k) == (c.ms, c.bound_by, c.flops)
    u = fa_ops.cost(q, meta(8, 1500, 4, 64), meta(8, 1500, 4, 64),
                    causal=False)
    assert chip_smoke.flash_bound_full(q, meta(8, 1500, 4, 64)) == (
        u.ms, u.bound_by, u.flops)
    x, bc, h0 = meta(8, 128, 80, 64), meta(8, 128, 64), meta(8, 80, 64, 64)
    s = ssd_ops.cost(x, meta(8, 128, 80), bc, bc, h0)
    assert chip_smoke.ssd_bound(x, bc, h0, 128) == (s.ms, s.bound_by,
                                                    s.flops, s.bytes)
    assert chip_smoke._bound(1e6, 2e9) == (
        KernelCost(2e9, 1e6).ms, KernelCost(2e9, 1e6).bound_by)
    assert chip_smoke.RMS_OPS_PER_ELEMENT == rms_ops.OPS_PER_ELEMENT == 4
    assert chip_smoke.GN_OPS_PER_ELEMENT == gn_ops.OPS_PER_ELEMENT == 12
    assert np.isclose(chip_smoke.HBM_BYTES_PER_S, 3.35e12)
