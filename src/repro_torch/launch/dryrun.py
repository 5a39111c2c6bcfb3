"""Dry run on one H100: trace every (architecture x input shape) on the
meta device (shapes and types, no allocation, no arithmetic) and record
flops, bytes, kernel calls, memory and the card's roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
        tinyllama-1.1b --shape decode_32k [--opt] [--out DIR] [--force]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--opt]

The port of ``repro.launch.dryrun``, which lowers and compiles each step
for TPU meshes of 256 and 512 chips on ``ShapeDtypeStruct`` inputs.
Here the step runs eagerly on meta tensors under
``launch.trace_cost.TraceCost``: products and bytes by op, each kernel
wrapper's meta branch as one call at its ``cost``, the peak of live
storage.  It needs no card and runs nothing on one.  The records are
one card's: ``run_for`` is the reference's with ``fsdp`` and
``shard_kv_seq`` off, and no record has a collective term (the port
shards over a device mesh, ``launch/shardings.py``, but the dry run's
collective term at the production meshes is still to come, ROADMAP
queue 1 item 3).  Records go
to ``artifacts/dryrun_torch/<arch>_<shape>[_opt].json``;
``ddim-cifar10`` is left out, as in the reference.  ``--smoke`` traces
each arch's smoke variant instead of its full width.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.config import (SHAPES, RunConfig, get_config, list_archs,
                                smoke_variant)
from repro_torch.kernels import CARD, HBM_BYTES
from repro_torch.launch.trace_cost import TraceCost
from repro_torch.models import api
from repro_torch.training import optimizer as optim
from repro_torch.training.train import make_train_step

OUT = "artifacts/dryrun_torch"


def run_for(cfg, shape, opt: bool = False) -> RunConfig:
    """The reference's ``run_for`` on one card: ``remat`` by family for
    training ("group" for the VLM, hybrid and ssm families, "block" for
    the rest), ``decode_window = 8192`` at ``long_500k`` for every arch
    with attention, and under ``opt`` its serving knobs.  ``fsdp`` and
    ``shard_kv_seq`` (the VLM's serving fsdp, ``long_500k``'s cache
    sharding) stay off: one card still has no collective term for them,
    so the slice-reads knob follows the window alone."""
    decode_window = 0
    remat = "none"
    if shape.kind == "train":
        remat = "group" if cfg.family in ("vlm", "hybrid", "ssm") \
            else "block"
    if shape.name == "long_500k" and cfg.family != "ssm":
        decode_window = 8192
    kwargs = {}
    if opt:
        kwargs = dict(prefill_logits="last",
                      decode_inplace_cache=(shape.kind == "decode"),
                      decode_slice_reads=bool(decode_window),
                      decode_uniform_pos=(shape.kind == "decode"),
                      prefill_parallel_q=(shape.kind == "prefill"
                                          and cfg.num_heads % 16 != 0))
    return RunConfig(remat=remat, decode_window=decode_window, **kwargs)


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
    """Bytes of the tensors of ``trees`` (``nbytes``), each counted
    once."""
    seen = {}
    for tree in trees:
        for t in optim.leaves(_tensor_tree(tree)):
            seen[id(t)] = t.nbytes
    return sum(seen.values())


def _tensor_tree(tree):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()
                if v is not None}
    if isinstance(tree, (list, tuple)):
        return [_tensor_tree(v) for v in tree]
    return tree if isinstance(tree, torch.Tensor) else []


def step_arguments(cfg, shape, run, dtype=torch.bfloat16):
    """(params, opt_state or None, batch) on the meta device: params of
    ``dtype`` (``api.abstract_model``), AdamW's float32 moments for
    train, and ``api.input_specs``."""
    params = api.abstract_model(cfg, dtype)
    state = optim.init_state(params) if shape.kind == "train" else None
    return params, state, api.input_specs(cfg, shape, run, abstract=True)


def analyze(arch: str, shape, opt: bool = False,
            dtype: torch.dtype = torch.bfloat16, *,
            smoke: bool = False, max_len=None) -> dict:
    """Trace ``arch``'s step at ``shape`` (a ``SHAPES`` name or a
    ``ShapeConfig``) on params of ``dtype`` (a prefill's cache of
    ``max_len`` rows, by default ``seq_len``) and return its record: the
    reference's keys where they mean the same on one card
    (``hlo_flops_per_chip`` and ``hlo_bytes_per_chip`` are the trace's
    counts) and ``kernels``, ``trace_seconds``, ``fits_one_card``."""
    cfg = get_config(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    run = run_for(cfg, shape, opt=opt)
    t0 = time.perf_counter()
    params, state, batch = step_arguments(cfg, shape, run, dtype)
    step = build_step(cfg, shape, run, max_len)
    args = (params, batch) if state is None else (params, state, batch)
    arg_ids = {id(t.untyped_storage()) for t in opt_leaves(args)}
    with TraceCost() as tc:
        out = step(*args)
    trace_s = time.perf_counter() - t0
    made = [t for t in opt_leaves(out)
            if id(t.untyped_storage()) not in arg_ids]
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_active \
        * tokens
    terms = {"compute_s": tc.compute_s, "memory_s": tc.memory_s}
    argument = tree_bytes(*args)
    return {
        "arch": arch, "shape": shape.name, "opt": opt, "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "dtype": str(dtype).replace("torch.", ""), "smoke": smoke,
        "mesh": "1xH100", "chips": 1, "card": CARD,
        "run": dataclasses.asdict(run),
        "trace_seconds": trace_s,
        "ops": tc.ops,
        "hlo_flops_per_chip": tc.flops,
        "hlo_bytes_per_chip": tc.total_bytes,
        "product_flops": tc.product_flops,
        "memory_analysis": {"argument_bytes": argument,
                            "output_bytes": sum(t.nbytes for t in made),
                            "temp_bytes": tc.peak_bytes},
        "roofline": {**terms, "dominant": max(terms, key=terms.get)},
        "model_flops_total": model_flops,
        "useful_flops_ratio": model_flops / tc.flops if tc.flops else 0.0,
        "params": cfg.param_count(), "active_params": n_active,
        "kernels": {k: {"calls": v["calls"], "flops": v["flops"],
                        "bytes": v["bytes"]}
                    for k, v in sorted(tc.kernels.items())},
        "fits_one_card": argument + tc.peak_bytes <= HBM_BYTES,
    }


def opt_leaves(tree):
    return optim.leaves(_tensor_tree(tree))


def record_path(out: str, arch: str, shape: str, opt: bool) -> str:
    return os.path.join(out, f"{arch}_{shape}{'_opt' if opt else ''}.json")


def summary(rec: dict) -> str:
    r = rec["roofline"]
    return (f"{rec['arch']} {rec['shape']}{' opt' if rec['opt'] else ''}: "
            f"fits {rec['fits_one_card']}, {r['dominant']}, roofline "
            f"{max(r['compute_s'], r['memory_s']) * 1e3:.3f} ms, traced in "
            f"{rec['trace_seconds']:.2f} s")


def sweep(archs, shapes, opt: bool = False, out: str = OUT,
          force: bool = False, smoke: bool = False, echo=print) -> list:
    """Every (arch, shape): its record written under ``out`` (kept where
    one is there, unless ``force``); ``shapes`` are names or
    ``ShapeConfig``s.  Returns the failures, (tag, error)."""
    os.makedirs(out, exist_ok=True)
    failures = []
    for arch in archs:
        for shape in shapes:
            name = shape if isinstance(shape, str) else shape.name
            path = record_path(out, arch, name, opt)
            if os.path.exists(path) and not force:
                echo(f"[skip] {path}")
                continue
            try:
                rec = analyze(arch, shape, opt, smoke=smoke)
            except Exception as e:   # noqa: BLE001 - listed, then raised
                failures.append((f"{arch}_{name}", repr(e)))
                echo(f"  FAIL {arch} {name}: {e}\n{traceback.format_exc()}")
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
    failures = sweep(archs, shapes, args.opt, args.out, args.force,
                     args.smoke)
    if failures:
        print(f"\n{len(failures)} failures:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        return 1
    print("\nall dry runs passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
