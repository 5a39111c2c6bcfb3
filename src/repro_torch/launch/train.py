"""Training launcher: one architecture on one device or sharded over a
device mesh, at a reduced or full config.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 50 [--ckpt /tmp/ck.npz] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --smoke --model-parallel 2

The port of ``repro.launch.train`` with its options, every arch of the
reference (whisper and the VLM over the reference's stub modality
inputs) and ``--remat`` none / block / group / full, plus ``--device``
(default ``cuda``; without a card it raises unless ``--device cpu``).
It prints the reference's lines, with the card's name and power limit,
tokens/s and peak device memory.  The checkpoint holds {"params",
"opt"} under the reference's keys.

Sharded (every arch), as the reference's: a ``(data, model)`` mesh of
``(world // N, N)`` for ``--model-parallel N`` over the process group
(one that the caller started, or ``torchrun``'s, NCCL on the card and
gloo on the CPU, else a world of one started here), the rules of
``sharding_rules_for``, params and optimizer state distributed by
``shardings.model_param_pspecs``, batches and whisper's and the VLM's
stub modality inputs sharded on ``data`` (the step shards the
latter).  It runs sharded whenever a process group exists or
``--model-parallel`` is above 1; the checkpoint is gathered and written
by rank 0.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.config import (RunConfig, get_config, sharding_rules_for,
                                smoke_variant)
from repro_torch.launch import mesh as meshes, shardings as shd
from repro_torch.models import api
from repro_torch.models.params import use_rules
from repro_torch.training import checkpoint, optimizer as opt
from repro_torch.training.data import DataConfig, batches
from repro_torch.training.train import make_train_step, release


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    the device's name where there is no card."""
    if dev.type != "cuda":
        return f"device {dev}"
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={torch.cuda.current_device()}"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"{torch.cuda.get_device_name(dev)} (nvidia-smi: {e})"
    return f"device {dev}: {smi}"


def start_world(model: int, device: str):
    """The process group to shard over: the caller's, ``torchrun``'s
    (its environment), or a world of one started here over a file
    store.  Returns (world size, the device of this rank, whether it was
    started here).  Raises when ``model`` does not divide the world."""
    started = not dist.is_initialized()
    world = dist.get_world_size() if not started else \
        int(os.environ.get("WORLD_SIZE", "1"))
    if world % model:
        raise ValueError(f"--model-parallel {model} does not divide the "
                         f"{world} rank(s) of the process group")
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if started:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ:
            dist.init_process_group(backend)
        else:
            store = os.path.join(tempfile.mkdtemp(), "store")
            dist.init_process_group(backend, init_method=f"file://{store}",
                                    rank=0, world_size=1)
    return dist.get_world_size(), dev, started


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    run = RunConfig(remat=args.remat)
    sharded = args.model_parallel > 1 or dist.is_initialized() \
        or "RANK" in os.environ
    mesh, rules, started, rank = None, None, False, 0
    if sharded:
        world, dev, started = start_world(args.model_parallel, args.device)
        rank = dist.get_rank()
        mesh = meshes.make_host_mesh(model=args.model_parallel,
                                     device_type=dev.type)
        sizes = meshes.mesh_axis_sizes(mesh)
        rules = sharding_rules_for(cfg, sizes, run)
        where = f"mesh={sizes} devices={world} {card_line(dev)}"
    else:
        dev = resolve_device(args.device)
        where = card_line(dev)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M {where}")

    params = api.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if sharded:
        params = shd.distribute(params, mesh, shd.model_param_pspecs(
            cfg, rules, run.fsdp))
    opt_state = opt.init_state(params)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch)
    data = batches(dc)
    extras = api.extra_input_specs(cfg, args.batch, abstract=False,
                                   device=dev)
    step_fn = make_train_step(cfg, run, ocfg)

    def place(a):
        t = torch.as_tensor(a, device=dev)
        return shd.distribute(t, mesh, shd.batch_spec(rules, None)) \
            if sharded else t

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    with use_rules(rules):
        for i in range(args.steps):
            toks, labels = next(data)
            params, opt_state, m = step_fn(params, opt_state, place(toks),
                                           place(labels), extras)
            if i % args.log_every == 0 or i == args.steps - 1:
                say(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                    f"lr {float(m['lr']):.2e}  "
                    f"|g| {float(m['grad_norm']):.2f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq_len / dt
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured (CPU)")
    say(f"done: {args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s); "
        f"peak device memory {peak}")

    release(params)
    if args.ckpt:
        checkpoint.save(args.ckpt, {"params": params, "opt": opt_state})
        say(f"checkpoint -> {args.ckpt}")
    if started:
        dist.destroy_process_group()
    return params, opt_state


if __name__ == "__main__":
    main()
