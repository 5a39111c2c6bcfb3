"""Training launcher: one architecture on one device, at a reduced or
full config.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --smoke --steps 50 [--ckpt /tmp/ck.npz] [--device cpu]

The port of ``repro.launch.train`` with its options, every arch of the
reference (whisper and the VLM over the reference's stub modality
inputs) and ``--remat`` none / block / group / full, plus ``--device``
(default ``cuda``; without a card it raises unless ``--device cpu``).
It prints the reference's lines, with the card's name and power limit,
tokens/s and peak device memory.  The checkpoint holds {"params",
"opt"} under the reference's keys.  Sharding over several devices
(``--model-parallel`` > 1) is not ported.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from repro_torch import resolve_device
from repro_torch.config import RunConfig, get_config, smoke_variant
from repro_torch.models import api
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
    if args.model_parallel > 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel}: sharded training is "
            f"not ported (ROADMAP queue 1 item 9)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    run = RunConfig(remat=args.remat)
    dev = resolve_device(args.device)
    print(f"arch={cfg.name} params~{cfg.param_count() / 1e6:.1f}M "
          f"{card_line(dev)}")

    params = api.init_model(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = opt.init_state(params)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch)
    data = batches(dc)
    extras = api.extra_input_specs(cfg, args.batch, abstract=False,
                                   device=dev)
    step_fn = make_train_step(cfg, run, ocfg)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    for i in range(args.steps):
        toks, labels = next(data)
        params, opt_state, m = step_fn(
            params, opt_state, torch.as_tensor(toks, device=dev),
            torch.as_tensor(labels, device=dev), extras)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"|g| {float(m['grad_norm']):.2f}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    tok_s = args.steps * args.batch * args.seq_len / dt
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured (CPU)")
    print(f"done: {args.steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s); "
          f"peak device memory {peak}")

    release(params)
    if args.ckpt:
        checkpoint.save(args.ckpt, {"params": params, "opt": opt_state})
        print(f"checkpoint -> {args.ckpt}")
    return params, opt_state


if __name__ == "__main__":
    main()
