"""Dry run: trace every (architecture x input shape) on the meta device
(shapes and types, no allocation, no arithmetic) and record flops,
bytes, kernel calls, memory, collectives and the card's roofline, on
one H100 or per card of a production mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        tinyllama-1.1b --shape decode_32k [--opt] [--out DIR] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        tinyllama-1.1b --shape long_500k --both-meshes   # or --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--opt]

The port of ``repro.launch.dryrun``, which lowers and compiles each step
for TPU meshes of 256 and 512 chips on ``ShapeDtypeStruct`` inputs.
Here the step runs eagerly on meta tensors under
``launch.trace_cost.TraceCost``: products and bytes by op, each kernel
wrapper's meta branch as one call at its ``cost``, the peak of live
storage, and the collectives.  It needs no card and runs nothing on
one.  ``mesh="1xH100"`` (the default, and ``--all`` without
``--both-meshes`` or ``--multi-pod``) traces one card: ``run_for``
without ``fsdp`` and ``shard_kv_seq``, no collective term.  At "16x16"
and "2x16x16" (``MESHES``) the reference's ``run_for`` and
``rules_for`` hold whole: a ``fake`` process group of 256 or 512 ranks
in this process, the production mesh over it, the params, AdamW state
and batch distributed by ``launch.shardings``' specs as meta DTensors,
and rank 0's step traced: per card, as the reference's numbers are per
partition.  Its collectives are priced at the H100 links their groups
cross (``link_rates``).  Records go to
``artifacts/dryrun_torch/<arch>_<shape>[_<mesh>][_opt].json`` (no mesh
in the name for one card); ``ddim-cifar10`` is left out, as in the
reference.  ``--smoke`` traces each arch's smoke variant instead of its
full width.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.config import (SHAPES, RunConfig, get_config, list_archs,
                                sharding_rules_for, smoke_variant)
from repro_torch.kernels import (CARD, GPUS_PER_NODE, HBM_BYTES,
                                 NODE_LINK_BYTES_PER_S, NVLINK_BYTES_PER_S)
from repro_torch.launch import shardings as shd
from repro_torch.launch.mesh import make_production_mesh, mesh_axis_sizes
from repro_torch.launch.trace_cost import COLLECTIVE_NAMES, TraceCost
from repro_torch.models import api
from repro_torch.models.params import use_rules
from repro_torch.training import optimizer as optim
from repro_torch.training.train import make_train_step

OUT = "artifacts/dryrun_torch"
# mesh name -> ranks of the production mesh (None: one card)
MESHES = {"1xH100": None, "16x16": 256, "2x16x16": 512}


def run_for(cfg, shape, opt: bool = False, mesh: str = "1xH100"
            ) -> RunConfig:
    """The reference's ``run_for``.  At a production mesh ("16x16",
    "2x16x16") its form whole: ``fsdp`` for train and for the VLM's
    serving, ``remat`` by family for train ("group" for the VLM, hybrid
    and ssm families, "block" for the rest), at ``long_500k``
    ``shard_kv_seq`` and ``decode_window = 8192`` for every family but
    ssm, and under ``opt`` its serving knobs, slice reads only where the
    cache is not split along its sequence.  On one card ("1xH100")
    ``fsdp`` and ``shard_kv_seq`` stay off (one card has nothing to
    split them over), so the slice-reads knob follows the window
    alone."""
    decode_window = 0
    remat = "none"
    fsdp = shard_kv_seq = False
    if shape.kind == "train":
        fsdp = True
        remat = "group" if cfg.family in ("vlm", "hybrid", "ssm") \
            else "block"
    if shape.name == "long_500k" and cfg.family != "ssm":
        shard_kv_seq = True
        decode_window = 8192
    if cfg.name == "llama-3.2-vision-90b" and shape.kind != "train":
        fsdp = True
    if mesh == "1xH100":
        fsdp = shard_kv_seq = False
    kwargs = {}
    if opt:
        kwargs = dict(prefill_logits="last",
                      decode_inplace_cache=(shape.kind == "decode"),
                      decode_slice_reads=bool(decode_window)
                      and not shard_kv_seq,
                      decode_uniform_pos=(shape.kind == "decode"),
                      prefill_parallel_q=(shape.kind == "prefill"
                                          and cfg.num_heads % 16 != 0))
    return RunConfig(fsdp=fsdp, remat=remat, decode_window=decode_window,
                     shard_kv_seq=shard_kv_seq, **kwargs)


def rules_for(cfg, shape, run, mesh, opt: bool = False) -> dict:
    """The reference's ``rules_for``: ``sharding_rules_for`` at the
    mesh's axis sizes (``mesh``: a device mesh or a dict of them), with
    ``batch`` dropped where the data ways do not divide the batch
    (``long_500k``'s B = 1), ``seq`` on ``model`` for train, and under
    ``opt`` the sequence on ``model`` where the heads do not split over
    it: prefill's ``seq`` where the query heads do not, decode's
    ``kv_seq`` where the KV heads do not (TinyLlama's 4 on a 16-wide
    axis), unless the cache's sequence is already split."""
    sizes = dict(mesh) if isinstance(mesh, dict) else mesh_axis_sizes(mesh)
    rules = sharding_rules_for(cfg, sizes, run)
    data_ways = sizes.get("data", 1) * sizes.get("pod", 1)
    if shape.global_batch % data_ways:
        rules["batch"] = None
    if shape.kind == "train":
        rules["seq"] = ("model",)
    if opt and shape.kind == "prefill" and rules.get("heads") is None \
            and "model" in sizes:
        rules["seq"] = ("model",)
    if opt and shape.kind == "decode" and rules.get("kv_heads") is None \
            and "model" in sizes:
        if not (rules.get("kv_seq") or ()):
            rules["kv_seq"] = ("model",)
    return rules


def build_step(cfg, shape, run, max_len=None):
    """The step of ``shape.kind``, taking (params, [opt_state,] batch)
    with ``batch`` as ``api.input_specs`` gives it: train is
    ``make_train_step``'s loss, backward and AdamW update; prefill (its
    cache of ``max_len`` rows, by default ``seq_len``, the reference's)
    and decode run under ``torch.no_grad()``, as serving does."""
    if shape.kind == "train":
        step = make_train_step(cfg, run)

        def train_step(params, opt_state, batch):
            return step(params, opt_state, batch["tokens"], batch["labels"],
                        batch.get("extras"))
        return train_step
    if shape.kind == "prefill":
        pre = api.make_prefill_step(cfg, run,
                                    max_len=max_len or shape.seq_len)

        @torch.no_grad()
        def prefill_step(params, batch):
            return pre(params, batch["tokens"], batch.get("extras"))
        return prefill_step
    dec = api.make_decode_step(cfg, run)

    @torch.no_grad()
    def serve_step(params, batch):
        return dec(params, batch["token"], batch["cache"],
                   batch.get("extras"))
    return serve_step


def tree_bytes(*trees) -> int:
    """Bytes of the tensors of ``trees`` (``nbytes``; a DTensor's local
    block), each counted once."""
    seen = {}
    for t in opt_leaves(trees):
        seen[id(t)] = t.nbytes
    return sum(seen.values())


def _tensor_tree(tree):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()
                if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_tensor_tree(v) for v in tree]
    return tree if isinstance(tree, torch.Tensor) else []


def opt_leaves(tree):
    """The tensors of ``tree``, each DTensor as its local block."""
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in optim.leaves(_tensor_tree(tree))]


def step_arguments(cfg, shape, run, dtype=torch.bfloat16):
    """(params, opt_state or None, batch) on the meta device: params of
    ``dtype`` (``api.abstract_model``), AdamW's float32 moments for
    train, and ``api.input_specs``."""
    params = api.abstract_model(cfg, dtype)
    state = optim.init_state(params) if shape.kind == "train" else None
    return params, state, api.input_specs(cfg, shape, run, abstract=True)


def link_rates(mesh) -> dict:
    """Each mesh axis's link rate (bytes/s a GPU, one way) and why: the
    ranks of an axis's group of rank 0, laid out in the mesh's order
    over nodes of ``GPUS_PER_NODE``, lie in one node (NVLink) or span
    several (the node link, which bounds the group's ring)."""
    sizes = mesh_axis_sizes(mesh)
    out, stride = {}, 1
    for name in reversed(list(sizes)):
        span = stride * (sizes[name] - 1) + 1
        inside = span <= GPUS_PER_NODE
        out[name] = {
            "bytes_per_s": NVLINK_BYTES_PER_S if inside
            else NODE_LINK_BYTES_PER_S,
            "link": "NVLink 4 inside a node (H100 data sheet: 900 GB/s a "
                    "GPU both ways)" if inside else
                    "one 400 Gb/s NDR link a GPU between nodes (DGX H100 "
                    "data sheet)",
            "why": f"its group spans {span} consecutive ranks, "
                   f"{'inside' if inside else 'across'} nodes of "
                   f"{GPUS_PER_NODE}"}
        stride *= sizes[name]
    return dict(reversed(list(out.items())))


@contextlib.contextmanager
def production_mesh(name: str):
    """The production mesh ``name`` ("16x16" or "2x16x16") over a
    ``fake`` process group of its ranks in this process, as rank 0
    (collectives move nothing; on meta tensors they give their outputs'
    shapes); the group is torn down on exit.  DTensor moves a shard
    between dims by all-to-all on the card but by all-gather and chunk
    on a CPU mesh (gloo has no all-to-all); here it takes the card's
    all-to-all."""
    import torch.distributed as dist
    from torch.distributed.tensor import placement_types
    from torch.distributed import _functional_collectives as funcol
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run at a production mesh starts its own "
                           "fake process group; one is running already")

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        group = funcol._resolve_group((mesh, mesh_dim))
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, funcol._group_or_group_name(group))
    dist.init_process_group("fake", rank=0, world_size=MESHES[name],
                            store=FakeStore())
    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = all_to_all
    try:
        yield make_production_mesh(multi_pod=name == "2x16x16",
                                   device_type="cpu")
    finally:
        placement_types.shard_dim_alltoall = saved
        dist.destroy_process_group()


def _mesh_arguments(cfg, shape, run, rules, mesh, dtype):
    """``step_arguments`` distributed on ``mesh`` as meta DTensors by
    the specs of ``launch.shardings``."""
    params, state, batch = step_arguments(cfg, shape, run, dtype)
    params = shd.distribute(params, mesh, shd.model_param_pspecs(
        cfg, rules, run.fsdp))
    if state is not None:
        state = shd.distribute(state, mesh, shd.opt_state_pspecs(
            cfg, rules, run.fsdp))
    batch = shd.distribute(batch, mesh, shd.input_pspecs(cfg, shape, run,
                                                         rules))
    return params, state, batch


def analyze(arch: str, shape, opt: bool = False,
            dtype: torch.dtype = torch.bfloat16, *,
            smoke: bool = False, max_len=None, mesh: str = "1xH100") -> dict:
    """Trace ``arch``'s step at ``shape`` (a ``SHAPES`` name or a
    ``ShapeConfig``) on params of ``dtype`` (a prefill's cache of
    ``max_len`` rows, by default ``seq_len``) on one card or, per card,
    at the production ``mesh`` ("16x16", "2x16x16"), and return its
    record: the reference's keys where they mean the same
    (``hlo_flops_per_chip`` and ``hlo_bytes_per_chip`` are the trace's
    counts; at a mesh ``collective_bytes_per_chip``,
    ``collectives.counts`` and ``roofline.collective_s``) and
    ``kernels``, ``trace_seconds``, ``fits_one_card`` (the local
    blocks, at a mesh)."""
    if mesh not in MESHES:
        raise ValueError(f"mesh {mesh!r} is not one of {list(MESHES)}")
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    run = run_for(cfg, shape, opt=opt, mesh=mesh)
    step = build_step(cfg, shape, run, max_len)
    with contextlib.ExitStack() as stack:
        t0 = time.perf_counter()
        if MESHES[mesh] is None:
            rules, groups = None, {}
            params, state, batch = step_arguments(cfg, shape, run, dtype)
        else:
            m = stack.enter_context(production_mesh(mesh))
            rules = rules_for(cfg, shape, run, m, opt)
            params, state, batch = _mesh_arguments(cfg, shape, run, rules,
                                                   m, dtype)
            groups = {m.get_group(i).group_name: n
                      for i, n in enumerate(m.mesh_dim_names)}
            stack.enter_context(use_rules(rules))
            rates = link_rates(m)
        args = (params, batch) if state is None else (params, state, batch)
        arg_ids = {id(t.untyped_storage()) for t in opt_leaves(args)}
        with TraceCost(groups) as tc:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        made = [t for t in opt_leaves(out)
                if id(t.untyped_storage()) not in arg_ids]
        argument = tree_bytes(*args)
        by_input = {"params": tree_bytes(params)}
        if state is not None:
            by_input["opt_state"] = tree_bytes(state)
        for key, val in batch.items():
            if key == "cache":
                by_input.update({f"cache/{k}": tree_bytes(v)
                                 for k, v in val.items()})
            else:
                by_input[key] = tree_bytes(val)
    chips = MESHES[mesh] or 1
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active \
        * tokens
    terms = {"compute_s": tc.compute_s, "memory_s": tc.memory_s}
    rec = {
        "arch": arch, "shape": shape.name, "opt": opt, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "dtype": str(dtype).replace("torch.", ""), "smoke": smoke,
        "mesh": mesh, "chips": chips, "card": CARD,
        "run": dataclasses.asdict(run),
        "trace_seconds": trace_s,
        "ops": tc.ops,
        "hlo_flops_per_chip": tc.flops,
        "hlo_bytes_per_chip": tc.total_bytes,
        "product_flops": tc.product_flops,
        "memory_analysis": {"argument_bytes": argument,
                            "output_bytes": sum(t.nbytes for t in made),
                            "temp_bytes": tc.peak_bytes,
                            "argument_bytes_by_input": by_input},
        "model_flops_total": model_flops,
        "model_flops_per_chip": model_flops / chips,
        "useful_flops_ratio": (model_flops / chips) / tc.flops
        if tc.flops else 0.0,
        "params": cfg.param_count(), "active_params": n_active,
        "kernels": {k: {"calls": v["calls"], "flops": v["flops"],
                        "bytes": v["bytes"]}
                    for k, v in sorted(tc.kernels.items())},
        "fits_one_card": argument + tc.peak_bytes <= HBM_BYTES,
    }
    if rules is not None:
        by_axis = tc.collective_bytes_by_axis()
        slowest = min(r["bytes_per_s"] for r in rates.values())
        terms["collective_s"] = sum(
            n / rates.get(axis, {"bytes_per_s": slowest})["bytes_per_s"]
            for axis, n in by_axis.items())
        rec["rules"] = {k: v for k, v in sorted(rules.items())}
        rec["collective_bytes_per_chip"] = tc.collective_bytes
        rec["collectives"] = {
            "counts": {n: tc.collectives.get(n, {}).get("calls", 0)
                       for n in COLLECTIVE_NAMES} | {
                n: c["calls"] for n, c in tc.collectives.items()
                if n not in COLLECTIVE_NAMES},
            "bytes": {n: c["bytes"] for n, c in tc.collectives.items()},
            "bytes_by_axis": by_axis}
    rec["roofline"] = {**terms, "dominant": max(terms, key=terms.get)}
    if rules is not None:
        # each axis's collective operand bytes over its link's one-way
        # rate; a group the trace cannot name at the slowest
        rec["roofline"]["link_rates"] = rates
    return rec


def record_path(out: str, arch: str, shape: str, opt: bool,
                mesh: str = "1xH100") -> str:
    tag = "" if mesh == "1xH100" else f"_{mesh}"
    return os.path.join(out, f"{arch}_{shape}{tag}{'_opt' if opt else ''}"
                             f".json")


def summary(rec: dict) -> str:
    r = rec["roofline"]
    coll = f", collective {r['collective_s'] * 1e3:.3f} ms" \
        if "collective_s" in r else ""
    return (f"{rec['arch']} {rec['shape']} {rec['mesh']}"
            f"{' opt' if rec['opt'] else ''}: fits {rec['fits_one_card']}, "
            f"{r['dominant']}, compute {r['compute_s'] * 1e3:.3f} ms, "
            f"memory {r['memory_s'] * 1e3:.3f} ms{coll}, traced in "
            f"{rec['trace_seconds']:.2f} s")


def sweep(archs, shapes, opt: bool = False, out: str = OUT,
          force: bool = False, smoke: bool = False, echo=print,
          meshes=("1xH100",)) -> list:
    """Every (arch, shape, mesh): its record written under ``out`` (kept
    where one is there, unless ``force``); ``shapes`` are names or
    ``ShapeConfig``s.  Returns the failures, (tag, error)."""
    os.makedirs(out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            name = shape if isinstance(shape, str) else shape.name
            for mesh in meshes:
                path = record_path(out, arch, name, opt, mesh)
                if os.path.exists(path) and not force:
                    echo(f"[skip] {path}")
                    continue
                try:
                    rec = analyze(arch, shape, opt, smoke=smoke, mesh=mesh)
                except Exception as e:   # noqa: BLE001 - listed, raised
                    failures.append((f"{arch}_{name}_{mesh}", repr(e)))
                    echo(f"  FAIL {arch} {name} {mesh}: {e}\n"
                         f"{traceback.format_exc()}")
                    continue
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                echo("  " + summary(rec))
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 mesh (512 cards)")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the 16 x 16 and the 2 x 16 x 16 mesh")
    ap.add_argument("--opt", action="store_true",
                    help="the reference's serving knobs (RunConfig)")
    ap.add_argument("--smoke", action="store_true",
                    help="each arch's smoke variant, not its full width")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    archs = list_archs() if args.all or not args.arch else [args.arch]
    archs = [a for a in archs if a != "ddim-cifar10"]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = ("16x16", "2x16x16") if args.both_meshes \
        else ("2x16x16",) if args.multi_pod else ("1xH100",)
    failures = sweep(archs, shapes, args.opt, args.out, args.force,
                     args.smoke, meshes=meshes)
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        return 1
    print("\nall dry runs passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
