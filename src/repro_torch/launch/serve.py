"""Serving launcher: deadline-aware batched decoding with STACKING.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --smoke --requests 6 [--deadlines 0.2,0.5,1.0] [--device cpu]

The port of ``repro.launch.serve`` with its options, plus ``--device``
(default ``cuda``; without a card it raises unless ``--device cpu``) and
``--layers N``, which cuts the model to its first N layers at full
width (llama-3.2-vision-90b's 100 layers do not fit one card; 10 do).
whisper-tiny and llama-3.2-vision-90b are served against the
reference's stub modality inputs (zero audio frames, 0.02 vision
embeddings), batch 1, which the engine expands to each prefill's rows.
Submits synthetic prompts with heterogeneous deadlines, calibrates the
decode delay model on the device (the paper's Fig.-1a procedure), plans
token budgets with STACKING (Alg. 1), validates and executes the plan
with batched decode steps, and reports per-request outcomes against
greedy batching.  Weights are drawn on the device from a
``torch.Generator`` seeded with ``--seed``; deadlines and prompts come
from ``numpy.random.default_rng(--seed)``, as in the reference.  The
reference's lines are printed, with the card's name and power limit and
every request's tokens.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.config import RunConfig, get_config, replace, smoke_variant
from repro_torch.core.baselines import greedy_batching
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.service import ServiceRequest
from repro_torch.launch.train import card_line
from repro_torch.models import api
from repro_torch.serving.engine import ServingEngine


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--deadlines", default="",
                    help="comma-separated seconds; default random 0.2-1.5")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to this many layers (0: all)")
    return ap.parse_args(argv)


def serve(argv=None, delay: Optional[DelayModel] = None,
          echo=print) -> dict:
    """Run the launcher and return its report.  ``delay``: a g(X) to plan
    with in place of the calibration; ``echo`` prints each line."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    if args.layers:
        cfg = replace(cfg, num_layers=args.layers)
    dev = resolve_device(args.device)
    card = card_line(dev)
    echo(f"arch={cfg.name} layers={cfg.num_layers} "
         f"params~{cfg.param_count() / 1e6:.1f}M {card}")
    t0 = time.perf_counter()
    params = api.init_model(
        cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    echo(f"params drawn on {dev} in {init_s:.1f}s")
    run = RunConfig()
    extras = api.extra_input_specs(cfg, 1, abstract=False, device=dev)
    eng = ServingEngine(cfg, params, run, max_len=args.max_len,
                        extras=extras, device=dev)

    if delay is None:
        echo("calibrating decode delay model...")
        eng.measure_decode_delay(batch_sizes=(1, 2, 4))
    else:
        eng.delay = delay
    dm = eng.delay
    echo(f"  g(X) = {dm.a * 1e3:.2f}ms * X + {dm.b * 1e3:.2f}ms")

    rng = np.random.default_rng(args.seed)
    if args.deadlines:
        deadlines = [float(x) for x in args.deadlines.split(",")]
    else:
        deadlines = sorted(rng.uniform(0.2, 1.5, args.requests).tolist())
    ids = [eng.submit(rng.integers(0, cfg.vocab_size,
                                   args.prompt_len).astype(np.int32), d)
           for d in deadlines]

    plan = eng.plan()
    plan.validate()
    top = max(plan.steps_completed.values(), default=0)
    if args.prompt_len + top > args.max_len:
        raise ValueError(f"plan wants {top} tokens but --max-len "
                         f"{args.max_len} leaves room for "
                         f"{args.max_len - args.prompt_len}")
    t0 = time.time()
    out = eng.execute(plan)
    wall = time.time() - t0
    echo(f"\nexecuted {plan.num_batches} batches in {wall:.2f}s wall")
    echo(f"{'req':>4} {'deadline':>9} {'tokens':>7}")
    for rid, d in zip(ids, deadlines):
        echo(f"{rid:>4} {d:9.2f} {len(out[rid]):7d}  {out[rid]}")

    svcs = [ServiceRequest(id=i, deadline=d, spectral_eff=1.0)
            for i, d in enumerate(deadlines)]
    tp = {s.id: s.deadline for s in svcs}
    greedy = greedy_batching(svcs, tp, eng.delay)
    q_st = eng.quality.mean_fid(list(plan.steps_completed.values()))
    q_gr = eng.quality.mean_fid(list(greedy.steps_completed.values()))
    echo(f"\nmean quality penalty: stacking={q_st:.3f} greedy={q_gr:.3f}")
    return dict(arch=cfg.name, card=card, device=str(dev), init_s=init_s,
                delay=(dm.a, dm.b), deadlines=deadlines,
                steps={rid: plan.steps_completed[rid] for rid in ids},
                tokens={rid: list(out[rid]) for rid in ids},
                batches=plan.num_batches, wall_s=wall,
                quality_stacking=q_st, quality_greedy=q_gr)


def main(argv=None):
    serve(argv)


if __name__ == "__main__":
    main()
