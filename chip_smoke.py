#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line)
when it does not hold:

  1. device   -- needs torch.cuda.is_available(); prints the card's name
                 and power limit; turns TF32 off for cuDNN and matmul.
  2. build    -- builds every CUDA kernel (groupnorm_silu, rmsnorm,
                 flash_attention, decode_attention, ssd_scan) with nvcc,
                 one process per source, all at once; prints the seconds.
  3. kernels  -- groupnorm_silu's wrapper against its plain PyTorch
                 version on the card, at every shape one full-width
                 U-Net forward gives it, B in {1, 8, 16}, float32 (tol
                 2e-5) and bfloat16 (tol 2e-2); times at B=16 and B=8
                 (the DDIM step's batch): kernel, plain version, library
                 yardstick and the bound, beside the kernel's launch
                 plan (slab, threads, loads a thread, blocks, tile).
  4. main     -- the full-width ddim-cifar10 U-Net (35.7M params, random
                 weights from a seed) through the port's Provisioner on
                 the card: calibrate g(X) at batch 1..16, a K=8 scenario
                 with deadlines in multiples of the measured g(8), then
                 allocate (inv_se) -> plan (stacking) -> validate ->
                 simulate -> execute timed.  Kernel launch counts are
                 zeroed before and read after; every forward must have
                 launched groupnorm_silu once per gn_silu call.
  5. trace    -- where one DDIM step's time goes at batch 8: device
                 busy share, kernels by device time (torch.profiler),
                 host time of one wrapper call; then the same step as
                 one replay of the bucketed engine's CUDA graph.
  6. parity   -- a short plan (K=2) on the card (kernel) and on the CPU
                 (plain version), same params with conv_out redrawn and
                 same latents; final images agree within 1e-3 (max abs
                 error).
  6b. bucketed -- the bucketed pool engine, one CUDA graph per (pool
                 rows, bucket[, steps]), on the same U-Net: g(X) at batch
                 1..16 through the bucket graphs beside phase main's
                 dict curve; phase main's K=8 scenario through
                 Provisioner(execute="open", exec_engine="bucketed"),
                 timed; with conv_out redrawn (eps of order 1), on an
                 executor of its own, phase main's plan untimed
                 (multi-step graphs) and a plan with batches of every
                 size 16..1 timed (every padding), each against the dict
                 engine from the same latents, within MATCH_TOL (1e-5).
                 Graphs captured, capture seconds by key, replays, peak
                 memory of each engine, and exact groupnorm_silu
                 launches: 45 captured per step of each graph, counter =
                 45 x eager forwards + captured; executed = 45 x eager +
                 captured x replays.
  6c. closed  -- Provisioner.run(execute="closed") on both engines,
                 planned with the calibrated g and with g x 0.5 (drift
                 must replan): replans, refits, wall_clock /
                 predicted_wall(), FID, outage, per bucket; executed log
                 monotone, no resurrection, images finite, one dispatch
                 per batch, launches exact.
  6d. fleet   -- many edge servers (api/{online,multiserver,fleet}.py,
                 core/{fleet,multiserver,traffic}.py).  On the same
                 U-Net planned with phase main's g:
                 OnlineProvisioner(make_scenario(K=8, arrival_rate=...),
                 engine="torch", execute=True, seed=0) replays exactly
                 its simulated batches; a 2-cell speed-1
                 MultiServerProvisioner(engine="torch") runs each cell
                 through execute_report(mode="open",
                 exec_engine="bucketed"); images finite, groupnorm_silu
                 launches exact (45 a forward, replays counted).  Then
                 the fleet in epoch mode at benchmarks/fleet.py's reduced
                 scale (128 cells, ~10^5 arrivals, 64 epochs, inv_se) on
                 engine="torch" (every epoch's replans in one
                 torchplan.replan_many call on the card) and "vec":
                 mean FID within 1e-9, counts and peak_live_rows equal,
                 64 planner calls against 8192; at paper scale (512
                 cells, >= 10^6 arrivals) on torch; event mode on the
                 reference's 3-cell equivalence fleet against
                 simulate_online_multi within 1e-9; event mode on two
                 one-speed 10-cell fleets (tests/test_fleet.py's, and a
                 lightly loaded one) on torch against vec, so that
                 rounds batch several cells into one replan_many call;
                 and
                 MultiServerProvisioner on make_scenario(K=12,
                 n_servers=3, server_speed_range=(0.7, 1.3)) for every
                 placement (alternating at K=6) and both online
                 routers, torch against vec: assignments equal, mean
                 FID within 1e-9.

Then phases 7-10 run for each model of the llm_decode path, at full
width and depth with f32 weights drawn on the card from a seed:
TinyLlama-1.1B (22 layers) and Zamba2-2.7B (54 Mamba2 layers in 9
groups, one weight-shared attention block per group, 2.42B params):

  7. llm-main -- the model through Provisioner(workload=DecodeWorkload(
                 ...)): calibrate g(X) at batch 1..16, a K=8 scenario
                 with deadlines in multiples of g(8), then inv_se ->
                 stacking -> validate -> simulate -> timed execute.
                 Launch counts must be exact (expected_launches): per
                 prefill 22 flash (TinyLlama) or 9 flash and 54 ssd_scan
                 (Zamba2), per decode step 22 or 9 decode, per forward
                 45 or 127 rmsnorm; every request gets its planned
                 tokens.  Every kernel call is recorded by its shapes
                 and types.  TinyLlama then runs the same plan through
                 execute_plan(mode="open") on EXECUTORS["llm_decode"]:
                 launches exact, tokens equal to the Provisioner's.
  8. llm-kernels -- each kernel of the path, its wrapper against its
                 plain version at every call shape phase llm-main gave
                 it (batch 1..16; prompt 32 in the calibration, 128 in
                 provisioning; cache 512) and at the shapes of one
                 request (one prefill and one decode step) with B in
                 {1, 8}: float32, bfloat16 and f32-q/bf16-cache, windows
                 0 and 48 (tol 2e-5 / 2e-2; ssd_scan 3e-5 / 2e-2); times
                 at B=8 in the path's types: kernel, plain, library
                 (F.rms_norm, F.scaled_dot_product_attention; none for
                 ssd_scan), bound.
  9. llm-trace -- one decode step at batch 8: device busy and idle
                 share, kernels by device time, host time per wrapper.
 10. llm-parity -- K=2, prompt 16, 4 tokens each through DecodeWorkload
                 on the card (kernels) and the CPU (plain versions), on
                 weights drawn with std 0.02 (see parity_params): equal
                 greedy tokens (or a difference inside the logits'
                 margin) and the first decode step's logits within 2e-2
                 of the largest |logit|.  On both these weights and the
                 reference's init, logit_witness reports (ungated) the
                 card with kernels, the card with plain versions, the
                 CPU, and the CPU with the embedding moved by one ulp.

Then the MoE family, f32 weights drawn on the card from a seed, bf16
KV cache, TF32 off:

 10b. moe   -- (a) deepseek-moe-16b at full width and all 28 layers
                 (16.9B params, 62.9 GiB) through phases 7-9
                 (``llm_path``): the Provisioner with K=8, launches exact
                 (57 rmsnorm a forward, 28 flash a prefill, 28 decode a
                 step), init seconds, peak memory, one decode step at
                 batch 8 under the profiler; (c) qwen3-moe-30b-a3b at full
                 width and 8 of its 48 layers (the full depth is 122 GB in
                 f32), K=2, 4L+1 = 33 rmsnorm a forward (per-head q/k norm
                 over rows of 128), G=8 at D=128; (b) phase 8 on every
                 shape (a) and (c) gave the kernels; (d) phase 10 on
                 deepseek at 2 layers, full width, with the (b, s, k)
                 expert choices that differ between card and CPU and the
                 smallest top-K margin reported (ungated; the logits are
                 gated where no choice flipped); (e) ``python -m
                 repro_torch.launch.serve --arch deepseek-moe-16b
                 --requests 6`` in a child process on the released card:
                 exit 0, every request's tokens, both quality penalties.
                 The card is released (and its memory logged) before
                 deepseek is drawn.  The phase's launches join the
                 kernels line under ``launches_by_path["moe"]``.

Then training, on full-width TinyLlama-1.1B (f32 weights, TF32 off):

 11. train   -- (a) a 2-layer full-width model on std-0.02 weights, one
                 batch (B=2, S=128) on the card, where rmsnorm and
                 flash_attention launch through their autograd
                 Functions, and on the CPU: loss within 1e-4 relative,
                 every gradient leaf within 1e-3 x its largest |g|.
                 (b) all 22 layers from the launcher's init, B=8,
                 S=512, synthetic data (seed 0), 5 steps of train_loop
                 at lr 1e-3: every loss finite, after step 1 every leaf
                 has a finite non-zero .grad (no detached output), 45
                 rmsnorm and 22 flash launches a forward exactly; the
                 median step of steps 2-5, tokens/s and TFLOP/s against
                 the bound, peak memory; one more step split into
                 forward, backward and AdamW with memory at each; then 2
                 steps with remat="block" from the same params and data:
                 the same step-1 loss, grads within 1e-6 of each leaf's
                 max |g|, the recompute's 44 and 22 launches a step
                 counted, peak memory, and its split step.  (c) each
                 Function at every shape (a) and (b) gave it: forward
                 within 2e-5 of the plain version, grads == autograd
                 through the plain version.  (d) python -m
                 repro_torch.launch.train --steps 3 --seq-len 128
                 --batch 2 at full width; its npz checkpoint restores
                 with the port's checkpoint.restore.  The phase's
                 launches join the kernels line's rmsnorm and
                 flash_attention counts (``launches_by_path``).

Then the planner, which runs none of the kernels above:

 12. plan    -- the device planner engine (repro_torch.core.torchplan)
                 in float64 on the card, each result within 1e-9 mean
                 FID (PLAN_TOL) of the NumPy engines: stacking(engine=
                 "torch") at K=1024 and 10^4 on make_scenario(K,
                 seed=0) with tau' = deadline - 0.4 against vec, plans
                 valid (first-call, warm and vec ms, device-to-host
                 reads a call); the sweep at K=10^4 under the selection
                 (sort, radix), rounds between loop checks (1, 4, 16)
                 and 4-level chunks, counts equal; plan_many at S=1000,
                 K=20 on default_rng(2).uniform(7, 20), every 10th
                 scenario against vec stacking; replan_many at S=256,
                 K=20 with offsets and doomed services against the vec
                 residual replan; optimal_plan at K=8 against the scalar
                 DP; Provisioner(scheduler="stacking_offset",
                 engine="torch").run(execute="closed") on the simulated
                 executor against engine="vec", with a replan.

The last lines are the card (nvidia-smi), one JSON object with the
kernels' numbers and, last, {"ok": true, "device": {...}}.  Details go
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense (data
                                   # sheet); flash_attention and
                                   # ssd_scan keep f32
TF32_PER_F32_OP = 3                # precision with 3xTF32: lo*hi + hi*lo
                                   # + hi*hi per f32 product
GN_OPS_PER_ELEMENT = 12            # mean 1, variance 3, normalize 4, SiLU 4
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 3e-5, "bfloat16": 2e-2}   # tests/test_kernels.py sweep
PARITY_TOL = 1e-3


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def device_time_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn()`` call: ``calls`` calls captured in a
    CUDA graph, replayed between CUDA events, so host launch overhead
    stays out of the reading.  Inputs repeat, so the reading is L2-warm,
    as the U-Net's own calls are (each reads what the op before wrote)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def phase_device():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]} torch {torch.__version__}"
        f" cuda {torch.version.cuda} | TF32 off (cudnn.allow_tf32=False, "
        f"cuda.matmul.allow_tf32=False)")
    return smi


def phase_build():
    from repro_torch.kernels import build
    names = ["groupnorm_silu", "rmsnorm", "flash_attention",
             "decode_attention", "ssd_scan"]
    t0 = time.perf_counter()
    took = build.build(names)
    log(f"[build] {names} in {time.perf_counter() - t0:.1f} s "
        f"(per library: {took or 'already built'})")
    for name in names:
        for line in build.build_log(name).splitlines():
            if "ptxas" in line:
                log(f"[build] {name}: {line.strip()}")


def gn_shapes(cfg):
    """(H, W, C) -> calls of gn_silu in one forward of ``cfg``, recorded
    on the card with B=1."""
    import torch
    from repro_torch.diffusion import unet
    from repro_torch.models.params import init_params
    seen = collections.Counter()
    real = unet.gn_silu

    def record(x, *a, **k):
        seen[tuple(x.shape[1:])] += 1
        return real(x, *a, **k)
    params = init_params(unet.schema(cfg), torch.Generator().manual_seed(0),
                         "cuda")
    x = torch.zeros((1, cfg.image_size, cfg.image_size, cfg.in_channels),
                    device="cuda")
    unet.gn_silu = record
    try:
        unet.forward(cfg, params, x, torch.zeros(1, device="cuda"))
    finally:
        unet.gn_silu = real
    return dict(sorted(seen.items()))


def gn_time_row(ops, B, H, W, C, G, calls=1, plain=True):
    """One per-shape timing row of groupnorm_silu at (B, H, W, C), f32:
    the wrapper, its plain version (when ``plain``), F.group_norm on an
    NCHW copy (GroupNorm only, the library yardstick) and the bound,
    each ms per call; with the wrapper's launch plan where it has one."""
    import dataclasses
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.groupnorm_silu.ref import groupnorm_silu_ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((B, H, W, C), generator=gen, device="cuda") * 2 + 0.5
    s = torch.randn(C, generator=gen, device="cuda")
    b = torch.randn(C, generator=gen, device="cuda")
    xn = x.permute(0, 3, 1, 2).contiguous()
    nbytes = 2 * x.numel() * 4 + 2 * C * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = GN_OPS_PER_ELEMENT * x.numel() / F32_OPS_PER_S * 1e3
    row = dict(shape=[B, H, W, C], calls=calls,
               ms=device_time_ms(lambda: ops.groupnorm_silu(x, s, b, G)),
               plain_ms=device_time_ms(
                   lambda: groupnorm_silu_ref(x, s, b, G)) if plain
               else None,
               group_norm_ms=device_time_ms(
                   lambda: F.group_norm(xn, G, s, b, 1e-6)),
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes)
    if hasattr(ops, "plan"):
        row["plan"] = dataclasses.asdict(
            ops.plan(B, H * W, C, ops.num_groups_for(C, G), 4))
    return row


def gn_plan_text(p):
    return (f"slab {p['slab']:>3} threads {p['threads']:>3} nv {p['nv']:>2} "
            f"blocks {p['blocks']:>4} tile {p['tile_bytes'] / 1024:>4.1f} KB")


def phase_kernels(cfg):
    import torch
    from repro_torch.diffusion import unet
    from repro_torch.kernels.groupnorm_silu import ops
    from repro_torch.kernels.groupnorm_silu.ref import groupnorm_silu_ref
    shapes = gn_shapes(cfg)
    calls = sum(shapes.values())
    check(calls == unet.gn_silu_calls(cfg),
          f"forward made {calls} gn_silu calls, schema says "
          f"{unet.gn_silu_calls(cfg)}")
    log(f"[kernels] groupnorm_silu: {calls} calls per forward at "
        f"{len(shapes)} (H,W,C) shapes: {shapes}")
    G = cfg.num_groups
    gen = torch.Generator(device="cuda").manual_seed(11)
    err = {"float32": 0.0, "bfloat16": 0.0}
    rows = []
    for (H, W, C), n in shapes.items():
        for B in (1, 8, 16):
            x32 = torch.randn((B, H, W, C), generator=gen, device="cuda") \
                * 2 + 0.5
            s = torch.randn(C, generator=gen, device="cuda")
            b = torch.randn(C, generator=gen, device="cuda")
            for name, dt in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
                x = x32.to(dt)
                got = ops.groupnorm_silu(x, s, b, G).float()
                want = groupnorm_silu_ref(x, s, b, G).float()
                torch.cuda.synchronize()
                e = float((got - want).abs().max())
                err[name] = max(err[name], e)
                tol = TOL[name]
                ok = bool(torch.allclose(got, want, atol=tol, rtol=tol))
                check(ok, f"groupnorm_silu {name} B={B} {(H, W, C)}: max "
                      f"abs err {e:.3g} over tolerance {tol}")
            if B != 1:
                rows.append(gn_time_row(ops, B, H, W, C, G, calls=n))
    log(f"[kernels] all {len(shapes)} shapes x B in (1, 8, 16) match the "
        f"plain version: max abs err float32 {err['float32']:.3g} "
        f"(tol 2e-5), bfloat16 {err['bfloat16']:.3g} (tol 2e-2)")
    log("[kernels] float32, device time per call (CUDA graph, L2-warm); "
        "library = F.group_norm on an NCHW copy, GroupNorm only; the "
        "kernel's launch plan (ops.plan)")
    log(f"[kernels] {'(B,H,W,C)':>18} {'calls':>5} {'kernel_us':>10} "
        f"{'plain_us':>9} {'library_us':>10} {'bound_us':>9} "
        f"{'bound/kern':>10}  plan")
    for r in sorted(rows, key=lambda r: r["shape"][0], reverse=True):
        log(f"[kernels] {str(tuple(r['shape'])):>18} {r['calls']:>5} "
            f"{r['ms'] * 1e3:>10.2f} {r['plain_ms'] * 1e3:>9.2f} "
            f"{r['group_norm_ms'] * 1e3:>10.2f} {r['bound_ms'] * 1e3:>9.2f} "
            f"{r['bound_ms'] / r['ms']:>10.3f}  {gn_plan_text(r['plan'])}")

    def per_forward(key, B=16):
        return sum(r[key] * r["calls"] for r in rows if r["shape"][0] == B)
    summary = dict(name="groupnorm_silu", route="cuda",
                   source="src/repro_torch/kernels/csrc/groupnorm_silu.cu",
                   replaces="src/repro/kernels/groupnorm_silu/kernel.py:36",
                   max_abs_err=err["float32"],
                   max_abs_err_bf16=err["bfloat16"],
                   ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
                   bound_ms=per_forward("bound_ms"),
                   bound_by="bytes" if all(r["bound_by"] == "bytes"
                                           for r in rows) else "operations",
                   library_ms=per_forward("group_norm_ms"),
                   timed_as=f"sum over the {calls} calls of one U-Net "
                            f"forward at B=16, float32",
                   ms_b8=per_forward("ms", 8),
                   bound_ms_b8=per_forward("bound_ms", 8),
                   library_ms_b8=per_forward("group_norm_ms", 8))
    for B in (16, 8):
        log(f"[kernels] per forward at B={B}: kernel "
            f"{per_forward('ms', B):.4f} ms, plain "
            f"{per_forward('plain_ms', B):.4f} ms, F.group_norm "
            f"{per_forward('group_norm_ms', B):.4f} ms, bound "
            f"{per_forward('bound_ms', B):.4f} ms")
    return summary, rows


def phase_main(cfg, card):
    import numpy as np
    import torch
    from repro_torch.api import DiffusionWorkload, Provisioner
    from repro_torch.core.delay_model import DelayModel, fit
    from repro_torch.core.service import Scenario, ServiceRequest
    from repro_torch.diffusion import unet
    from repro_torch.kernels.groupnorm_silu import ops
    from repro_torch.models.params import init_params

    calls = unet.gn_silu_calls(cfg)
    t0 = time.perf_counter()
    params = init_params(unet.schema(cfg), torch.Generator().manual_seed(0),
                         "cuda")
    wl = DiffusionWorkload(cfg=cfg, params=params, device="cuda")
    ex = wl._ex()
    n_params = sum(int(np.prod(p.shape)) for p in _leaves(ex.params))
    log(f"[main] {cfg.name}: {n_params} params (seeded random), built in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- calibrate: the paper's Fig. 1a on this card ----------------------
    sizes, reps = (1, 2, 4, 8, 16), 5
    ops.launches = 0
    curve = wl.measure_delay_curve(torch.Generator().manual_seed(1),
                                   batch_sizes=sizes, reps=reps)
    cal_launches = ops.launches
    check(cal_launches == calls * len(sizes) * (1 + reps),
          f"calibration launched groupnorm_silu {cal_launches} times, "
          f"expected {calls} x {len(sizes) * (1 + reps)} forwards")
    raw = fit([c[0] for c in curve], [c[1] for c in curve])
    # the reference's refit floor (DelayModel.refit): delays cannot
    # shrink with batch size, and the planners divide by a
    g = DelayModel(a=max(raw.a, 1e-9), b=max(raw.b, 1e-9))
    log(f"[main] delay curve (batch, best-of-{reps} s per DDIM step): "
        + ", ".join(f"{x}: {s * 1e3:.3f} ms" for x, s in curve))
    log(f"[main] fitted g(X) = {raw.a * 1e3:.4f} ms * X + "
        f"{raw.b * 1e3:.4f} ms on {card}; planning with a = "
        f"{g.a * 1e3:.4f} ms, b = {g.b * 1e3:.4f} ms")
    check(g.g(16) > 0 and g.b > 1e-6, f"degenerate delay fit {raw}")

    # -- provision a K=8 scenario with hardware-normalised deadlines ------
    K = 8
    multiples = np.linspace(20.0, 80.0, K)
    scn = Scenario(services=[
        ServiceRequest(id=k, deadline=float(multiples[k] * g.g(K) + 0.05),
                       spectral_eff=7.0) for k in range(K)],
        total_bandwidth_hz=40_000.0, content_bits=512.0)
    d0 = ex.dispatches
    ops.launches = 0
    t0 = time.perf_counter()
    rep = Provisioner(scn, workload=wl, scheduler="stacking",
                      allocator="inv_se", delay=g, device="cuda").run(
        torch.Generator().manual_seed(2), timed=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    main_launches = ops.launches
    forwards = ex.dispatches - d0
    plan = rep.plan
    check(forwards == plan.num_batches,
          f"{forwards} forwards for {plan.num_batches} batches")
    check(main_launches == calls * forwards,
          f"main path launched groupnorm_silu {main_launches} times for "
          f"{forwards} forwards; expected {calls} per forward")
    steps = [plan.steps_completed[k] for k in range(K)]
    check(min(steps) > 0, f"a service got no steps: {steps}")
    for k, img in rep.content.items():
        check(img.shape == (cfg.image_size, cfg.image_size,
                            cfg.in_channels) and bool(np.isfinite(img).all()),
              f"service {k}: bad image {img.shape}")
    measured = sum(s for _, s in rep.timings)
    predicted = plan.makespan()
    log(f"[main] K={K}: {plan.num_batches} batches, sizes "
        f"{dict(sorted(collections.Counter(plan.batch_sizes()).items()))}, "
        f"steps per service {steps}")
    log(f"[main] mean FID {rep.mean_fid:.4f}, outage {rep.outage_rate:.1%}; "
        f"execution measured {measured:.4f} s (sum of timed batches), "
        f"predicted {predicted:.4f} s (plan makespan under the fit), "
        f"measured/predicted {measured / predicted:.4f}; whole run "
        f"{wall:.3f} s")
    log(f"[main] groupnorm_silu launches: calibration {cal_launches}, "
        f"provisioning {main_launches} = {calls} x {forwards} forwards")
    return dict(curve=curve, fit_a=raw.a, fit_b=raw.b, a=g.a, b=g.b, K=K,
                batches=plan.num_batches,
                batch_sizes=plan.batch_sizes(), steps=steps,
                mean_fid=rep.mean_fid, outage_rate=rep.outage_rate,
                measured_s=measured, predicted_s=predicted, wall_s=wall,
                launches=cal_launches + main_launches,
                calibration_launches=cal_launches,
                provision_launches=main_launches, forwards=forwards), \
        wl, (scn, g)


def phase_trace(wl, batch: int = 8, steps: int = 5):
    """Where one DDIM step's time goes at ``batch``: torch.profiler over
    ``steps`` steps for device time by kernel, the same steps unprofiled
    for wall time, and the host time of one wrapper call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.groupnorm_silu import ops
    ex = wl._ex()
    cfg = ex.cfg
    x = torch.randn((batch, cfg.image_size, cfg.image_size,
                     cfg.in_channels), device="cuda")
    t = torch.full((batch,), ex.T_train // 2, device="cuda")
    ex.step_fn(x, t, t - 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        ex.step_fn(x, t, t - 1)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            ex.step_fn(x, t, t - 1)
        torch.cuda.synchronize()
    # device-side events only: an aten op's own entry repeats the time
    # of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev = {e.key: e.self_device_time_total / steps for e in events}
    launches = sum(e.count for e in events) / steps
    device_us = sum(dev.values())
    gn_us = sum(v for k, v in dev.items() if "groupnorm_silu_kernel" in k)
    busy = device_us / wall_us
    log(f"[trace] one DDIM step at batch {batch}: wall {wall_us:.0f} us "
        f"(unprofiled), device busy {device_us:.0f} us = "
        f"{busy:.1%} of wall, idle {1 - busy:.1%}"
        f"; {launches:.0f} kernels per step; groupnorm_silu "
        f"{gn_us:.0f} us = {gn_us / device_us:.1%} of device time")
    for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[trace]   {v:9.1f} us/step  {k[:90]}")
    # host time of one call, small shape: what eager dispatch costs
    xs = torch.randn((16, 4, 4, 256), device="cuda")
    sc, bi = torch.ones(256, device="cuda"), torch.zeros(256, device="cuda")
    host = {}
    for name, fn in (("groupnorm_silu wrapper",
                      lambda: ops.groupnorm_silu(xs, sc, bi, 32)),
                     ("torch.add", lambda: xs + 1.0)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host[name] = (time.perf_counter() - t0) * 1e6 / 200
        torch.cuda.synchronize()
    log("[trace] host us per call (200 calls, no sync): "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    graph = trace_bucketed(ex, batch, steps)
    return dict(batch=batch, wall_us=wall_us, device_us=device_us,
                busy=busy, launches_per_step=launches, gn_us=gn_us,
                top=sorted(dev.items(), key=lambda kv: -kv[1])[:8],
                host_us_per_call=host, bucketed_graph=graph)


def trace_bucketed(ex, batch: int, steps: int):
    """The same DDIM step at ``batch`` through a bucketed session, one
    graph replay a step: wall per replay (unprofiled), device time and
    kernels per replay (torch.profiler)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.plan import BatchPlan
    cfg = ex.cfg
    n = 2 * steps + 1
    ks = list(range(batch))
    plan = BatchPlan(batches=[[(k, i) for k in ks] for i in range(n)],
                     start_times=[0.0] * n,
                     steps_completed={k: n for k in ks}, delay=DelayModel())
    rng = np.random.default_rng(9)
    sess = ex.open_session(plan, latents={
        k: rng.standard_normal((cfg.image_size, cfg.image_size,
                                cfg.in_channels)).astype(np.float32)
        for k in ks}, exec_engine="bucketed")
    sess.run_batch(ks)                  # captures the graph if it is new
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sess.run_batch(ks)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sess.run_batch(ks)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev = {e.key: e.self_device_time_total / steps for e in events}
    launches = sum(e.count for e in events) / steps
    device_us = sum(dev.values())
    busy = device_us / wall_us
    gn_us = sum(v for k, v in dev.items() if "groupnorm_silu_kernel" in k)
    if device_us > 0:
        log(f"[trace] the same step on the bucketed graph (one replay a "
            f"step, batch {batch} in bucket {batch}): wall {wall_us:.0f} "
            f"us per replay, device busy {device_us:.0f} us = {busy:.1%} "
            f"of wall, idle {1 - busy:.1%}; {launches:.0f} kernels per "
            f"replay; groupnorm_silu {gn_us:.0f} us")
    else:
        log(f"[trace] the same step on the bucketed graph: wall "
            f"{wall_us:.0f} us per replay; the profiler recorded no device "
            f"time inside graph replays: kernels and busy share not "
            f"measured")
    return dict(wall_us=wall_us, device_us=device_us, busy=busy,
                launches_per_step=launches, gn_us=gn_us,
                top=sorted(dev.items(), key=lambda kv: -kv[1])[:8])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def redrawn(params):
    """The U-Net's params with conv_out redrawn (seed 7): it is
    initialised at 1e-10, so eps ~ 0 and a comparison of images would
    scale any error of the U-Net by 1e-10."""
    import torch
    params = dict(params)
    w = params["conv_out"]
    params["conv_out"] = torch.randn(
        w.shape, generator=torch.Generator().manual_seed(7)).to(w.device) \
        / math.sqrt(w.shape[1])
    return params


def phase_parity(cfg, params):
    import numpy as np
    from repro_torch.api import DiffusionWorkload
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.plan import BatchPlan
    from repro_torch.diffusion import unet
    from repro_torch.kernels.groupnorm_silu import ops

    # each executor moves the params to its own device
    params = redrawn(params)
    # K=2: service 0 takes 3 steps, service 1 takes 2; batch sizes 2, 2, 1
    plan = BatchPlan(batches=[[(0, 0), (1, 0)], [(0, 1), (1, 1)], [(0, 2)]],
                     start_times=[0.0, 1.0, 2.0],
                     steps_completed={0: 3, 1: 2}, delay=DelayModel())
    rng = np.random.default_rng(5)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    latents = {k: rng.standard_normal(shape).astype(np.float32)
               for k in (0, 1)}
    before = ops.launches
    on_card = DiffusionWorkload(cfg=cfg, params=params,
                                device="cuda").execute(
        plan, latents=latents).content
    check(ops.launches - before == 3 * unet.gn_silu_calls(cfg),
          "parity run on the card did not launch the kernel per gn_silu")
    on_cpu = DiffusionWorkload(cfg=cfg, params=params,
                               device="cpu").execute(
        plan, latents=latents).content
    scale = max(float(np.abs(v).max()) for v in on_cpu.values())
    err = max(float(np.abs(on_card[k] - on_cpu[k]).max()) for k in on_cpu)
    moved = min(float(np.abs(on_cpu[k] - latents[k]).max()) for k in on_cpu)
    check(moved > 1e-2, "parity images did not move from their latents")
    check(err <= PARITY_TOL,
          f"card vs CPU images: max abs err {err:.3g} over {PARITY_TOL}")
    log(f"[parity] K=2 plan (steps 3 and 2) card vs CPU, conv_out redrawn: "
        f"max abs err {err:.3g} (tolerance {PARITY_TOL}), largest |image| "
        f"{scale:.3g}")
    return dict(max_abs_err=err, image_scale=scale, tol=PARITY_TOL)


# ---------------------------------------------------------------------------
# The bucketed pool engine (CUDA graphs) and the closed loop
# ---------------------------------------------------------------------------

def gn_accounting(ex, before, counter: int, calls: int, tag: str):
    """Exact groupnorm_silu launches of one path run on executor ``ex``
    since ``before`` = (ex.graph_counts(), ex.forwards), the wrapper's
    counter zeroed at ``before`` and reading ``counter`` now.  The
    counter moves at eager calls and at capture, not at a replay, so:
    every graph must hold ``calls`` launches per step it runs, and the
    counter must be ``calls`` x eager forwards + the launches captured
    here.  The launches executed are then the eager ones + each graph's
    captured launches x its replays."""
    counts0, f0 = before
    counts = ex.graph_counts()
    for key, c in counts.items():
        check(c["launches"] == calls * c["steps"],
              f"{tag}: graph {key} captured {c['launches']} groupnorm_silu "
              f"launches for {c['steps']} steps")
    new = [k for k in counts if k not in counts0]
    replays = {k: c["replays"] - counts0.get(k, {"replays": 0})["replays"]
               for k, c in counts.items()}
    eager = ex.forwards - f0
    captured = sum(counts[k]["launches"] for k in new)
    check(counter == calls * eager + captured,
          f"{tag}: counter {counter}, expected {calls} x {eager} eager "
          f"forwards + {captured} captured")
    graph_forwards = sum(counts[k]["steps"] * r for k, r in replays.items())
    executed = calls * eager + sum(counts[k]["launches"] * r
                                   for k, r in replays.items())
    return dict(counter=counter, executed=executed, eager_forwards=eager,
                graph_forwards=graph_forwards, captures=len(new),
                replays=sum(replays.values()))


def _gn_run(ex, calls, tag, fn):
    """``fn()`` with the groupnorm_silu counter zeroed just before and
    read just after; returns (fn's result, gn_accounting)."""
    from repro_torch.kernels.groupnorm_silu import ops
    before = (ex.graph_counts(), ex.forwards)
    ops.launches = 0
    out = fn()
    import torch
    torch.cuda.synchronize()
    return out, gn_accounting(ex, before, ops.launches, calls, tag)


def phase_bucketed(wl, main, scn, g, card):
    """The bucketed engine at full width: g(X) through the bucket graphs,
    phase main's K=8 scenario open loop through the Provisioner, and one
    untimed run (multi-step graphs) beside the dict engine from the same
    latents."""
    import numpy as np
    import torch
    from repro_torch.api import DiffusionWorkload, Provisioner
    from repro_torch.core.delay_model import DelayModel, fit
    from repro_torch.core.execution import shape_bucket
    from repro_torch.core.plan import BatchPlan
    from repro_torch.diffusion import unet
    from repro_torch.diffusion.bucketed import MATCH_TOL
    ex = wl._ex()
    cfg = ex.cfg
    calls = unet.gn_silu_calls(cfg)
    clog0 = len(ex.compile_log)
    sizes, reps = (1, 2, 4, 8, 16), 5
    curve, acc_curve = _gn_run(ex, calls, "bucketed curve", lambda: (
        wl.measure_delay_curve(torch.Generator().manual_seed(1),
                               batch_sizes=sizes, reps=reps,
                               exec_engine="bucketed")))
    check(acc_curve["graph_forwards"] == len(sizes) * (1 + reps)
          and acc_curve["eager_forwards"] <= acc_curve["captures"],
          f"bucketed curve ran {acc_curve['graph_forwards']} forwards")
    raw = fit([c[0] for c in curve], [c[1] for c in curve])
    # the bucketed engine's own calibration, floored as phase main's is
    g_bucketed = DelayModel(a=max(raw.a, 1e-9), b=max(raw.b, 1e-9))
    check(g_bucketed.g(16) > 0 and g_bucketed.b > 1e-6,
          f"degenerate bucketed delay fit {raw}")
    dict_curve = dict(main["curve"])
    log(f"[bucketed] delay curve (batch: dict / bucketed graph, best-of-"
        f"{reps} s per DDIM step): " + ", ".join(
            f"{x}: {dict_curve[x] * 1e3:.3f} / {s * 1e3:.3f} ms"
            for x, s in curve))
    log(f"[bucketed] fitted g(X): dict {main['fit_a'] * 1e3:.4f} ms * X + "
        f"{main['fit_b'] * 1e3:.4f} ms; bucketed {raw.a * 1e3:.4f} ms * X + "
        f"{raw.b * 1e3:.4f} ms on {card}")

    t0 = time.perf_counter()
    rep, acc_open = _gn_run(ex, calls, "bucketed open loop", lambda: (
        Provisioner(scn, workload=wl, scheduler="stacking",
                    allocator="inv_se", delay=g, device="cuda",
                    execute="open",
                    execute_kwargs={"exec_engine": "bucketed"}).run(
            torch.Generator().manual_seed(2), timed=True)))
    wall_open = time.perf_counter() - t0
    plan, res = rep.plan, rep.execution
    check(acc_open["graph_forwards"] == plan.num_batches
          and acc_open["eager_forwards"] <= acc_open["captures"],
          f"open loop: {acc_open} for {plan.num_batches} batches")
    check(res.session_telemetry["dispatches"] == plan.num_batches,
          f"open loop: {res.session_telemetry['dispatches']} dispatches")
    for k, img in rep.content.items():
        check(bool(np.isfinite(img).all()), f"service {k}: image not finite")
    log(f"[bucketed] K={scn.K} open loop (Provisioner execute='open', "
        f"exec_engine='bucketed', timed): {plan.num_batches} batches, "
        f"measured {res.wall_clock:.4f} s, predicted (plan makespan) "
        f"{plan.makespan():.4f} s, measured/predicted "
        f"{res.wall_clock / plan.makespan():.4f} (dict, phase main: "
        f"{main['measured_s'] / main['predicted_s']:.4f}); whole run "
        f"{wall_open:.3f} s; per bucket " + ", ".join(
            f"{b}: {v['batches']} x {v['mean_s'] * 1e3:.3f} ms"
            for b, v in sorted(res.per_bucket().items())))

    # images: the same U-Net with conv_out redrawn (eps of order 1), on
    # an executor of its own: phase main's plan untimed (multi-step
    # graphs), then a plan whose batches take every size from 16 down
    # to 1 timed (a step graph per bucket, every padding), each against
    # the dict engine from the same latents
    wl_r = DiffusionWorkload(cfg=cfg, params=redrawn(wl.params),
                             device="cuda")
    ex_r = wl_r._ex()
    rng = np.random.default_rng(21)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    lat = {k: rng.standard_normal(shape).astype(np.float32)
           for k in plan.steps_completed}
    torch.cuda.reset_peak_memory_stats()
    want, acc_dict = _gn_run(ex_r, calls, "dict untimed", lambda: (
        wl_r.execute(plan, latents=lat, exec_engine="dict").content))
    check(acc_dict["eager_forwards"] == plan.num_batches,
          f"dict run: {acc_dict}")
    peak_dict = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = ex_r.open_session(plan, latents=lat, exec_engine="bucketed")
    got, acc_scan = _gn_run(ex_r, calls, "bucketed untimed", lambda: (
        sess.run_plan([[k for k, _ in b] for b in plan.batches]),
        sess.finish())[1])
    wall_scan = time.perf_counter() - t0
    peak_graph = torch.cuda.max_memory_allocated()
    tele = sess.telemetry()
    check(acc_scan["graph_forwards"] == plan.num_batches
          and acc_scan["eager_forwards"] <= acc_scan["captures"],
          f"bucketed untimed: {acc_scan} for {plan.num_batches} batches")
    sizes = sorted({len(b) for b in plan.batches})
    log(f"[bucketed] untimed run of the same plan (batch sizes {sizes}) "
        f"from the same latents, conv_out redrawn: {tele['dispatches']} "
        f"dispatches for {plan.num_batches} batches "
        f"({tele['scan_fused_steps']} steps in multi-step graphs "
        f"{tele['scan_dispatches']}, steps {tele['by_bucket']}), "
        f"{wall_scan:.3f} s with {tele['compiles']} captures "
        f"({tele['compile_s']:.3f} s)")
    every = {k: k + 1 for k in range(16)}      # sizes 16, 15, ..., 1
    rem, batches = dict(every), []
    while any(rem.values()):
        batches.append([(k, every[k] - rem[k]) for k in sorted(rem)
                        if rem[k]])
        for k, _ in batches[-1]:
            rem[k] -= 1
    plan16 = BatchPlan(batches=batches, start_times=[0.0] * len(batches),
                       steps_completed=every, delay=DelayModel())
    lat16 = {k: rng.standard_normal(shape).astype(np.float32)
             for k in every}
    want16 = wl_r.execute(plan16, latents=lat16, exec_engine="dict").content
    got16, acc16 = _gn_run(ex_r, calls, "bucketed every size", lambda: (
        ex_r.run(plan16, latents=lat16, timed=True,
                 exec_engine="bucketed")[0]))
    check(acc16["graph_forwards"] == len(batches),
          f"bucketed every size: {acc16} for {len(batches)} batches")
    errs = {}
    for tag, p_, g_, w_, l_ in (("phase main's plan", plan, got, want, lat),
                                ("sizes 16..1", plan16, got16, want16,
                                 lat16)):
        errs[tag] = max(float(np.abs(g_[k] - w_[k]).max()) for k in w_)
        over = sum(int((~np.isclose(g_[k], w_[k], **MATCH_TOL)).sum())
                   for k in w_)
        # one step is t = 0: it hardly moves the latent
        moved = min(float(np.abs(g_[k] - l_[k]).max())
                    for k, T in p_.steps_completed.items() if T > 1)
        scale_ = max(float(np.abs(v).max()) for v in w_.values())
        check(all(bool(np.isfinite(g_[k]).all()) for k in g_),
              f"{tag}: bucketed image not finite")
        check(over == 0, f"{tag}: bucketed vs dict max abs err "
              f"{errs[tag]:.3g}, {over} elements over MATCH_TOL")
        check(moved > 1e-2, f"{tag}: images did not move")
        log(f"[bucketed] {tag}, conv_out redrawn: bucketed vs dict max "
            f"abs err {errs[tag]:.3g}, {over} elements over MATCH_TOL "
            f"(atol = rtol = 1e-5), at |image| <= {scale_:.3g}")
    err = max(errs.values())
    scale = max(float(np.abs(v).max()) for v in want.values())

    # the longest chunk: a stable phase of 40 steps at batch 8 runs as
    # one 32-step and one 8-step graph; twice, the first run captures
    n, ks = 40, list(range(8))
    plan40 = BatchPlan(batches=[[(k, i) for k in ks] for i in range(n)],
                       start_times=[0.0] * n,
                       steps_completed={k: n for k in ks},
                       delay=DelayModel())
    walls40, acc40 = [], []
    for _ in range(2):
        sess40 = ex.open_session(plan40, latents={k: lat[k] for k in ks},
                                 exec_engine="bucketed")
        t0 = time.perf_counter()
        acc40.append(_gn_run(ex, calls, "stable phase of 40", lambda: (
            sess40.run_plan([ks] * n)))[1])
        walls40.append(time.perf_counter() - t0)
        check(acc40[-1]["graph_forwards"] == n
              and sess40.telemetry()["scan_dispatches"] ==
              {"b8_c32": 1, "b8_c8": 1}, f"stable phase: {acc40[-1]}, "
              f"{sess40.telemetry()['scan_dispatches']}")
    cap32 = [s for k, s in ex.compile_log
             if k == ("bscan", shape_bucket(len(ks) + 1), 8, 32)]
    log(f"[bucketed] a stable phase of {n} steps at batch 8 (one 32-step "
        f"and one 8-step graph): {walls40[0]:.3f} s with the 32-step "
        f"capture ({cap32[0] if cap32 else float('nan'):.3f} s), then "
        f"{walls40[1]:.3f} s = {walls40[1] / n * 1e3:.3f} ms a step")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - torch.cuda.memory_allocated()
    caps = ex.compile_log[clog0:] + ex_r.compile_log
    counts = {**ex.graph_counts(),
              **{("redrawn",) + k: c for k, c in ex_r.graph_counts().items()}}
    log(f"[bucketed] peak memory allocated: dict {peak_dict / 2**20:.1f} "
        f"MiB, bucketed with its graphs {peak_graph / 2**20:.1f} MiB; "
        f"after empty_cache, reserved beyond allocated (the graphs' "
        f"shared pools of two executors, {len(counts)} graphs) "
        f"{held / 2**20:.1f} MiB")
    log(f"[bucketed] {len(caps)} graphs captured, "
        f"{sum(s for _, s in caps):.3f} s in all: " + ", ".join(
            f"{k}: {s:.3f} s" for k, s in caps))
    log("[bucketed] replays by graph: " + ", ".join(
        f"{k}: {c['replays']}" for k, c in counts.items()))
    acc = {"curve": acc_curve, "open": acc_open, "dict": acc_dict,
           "untimed": acc_scan, "every_size": acc16, "stable_40": acc40[0],
           "stable_40_again": acc40[1]}
    executed = sum(a["executed"] for a in acc.values())
    log(f"[bucketed] groupnorm_silu launches executed (counter + captured "
        f"x replays, exact): " + ", ".join(
            f"{k} {a['executed']} = {calls} x "
            f"{a['eager_forwards'] + a['graph_forwards']}"
            for k, a in acc.items()))
    return g_bucketed, dict(curve=curve, fit_a=raw.a, fit_b=raw.b,
                open_measured_s=res.wall_clock,
                open_predicted_s=plan.makespan(),
                per_bucket=res.per_bucket(), max_abs_err=err,
                image_scale=scale, wall_untimed_s=wall_scan,
                telemetry_untimed=tele, peak_dict_bytes=peak_dict,
                peak_graph_bytes=peak_graph, graph_pool_held_bytes=held,
                stable_40_s=walls40, capture_32_s=cap32,
                captures=[[list(k), s] for k, s in caps],
                replays={str(k): c["replays"] for k, c in counts.items()},
                accounting=acc, launches=executed)


def phase_closed(wl, scn, models, card):
    """Provisioner.run(execute="closed") on both engines, each planned
    with its own calibrated g (``models[engine]``: the bucketed engine
    runs a step in about half the dict engine's time, so the dict g x 0.5
    is close to the bucketed truth) and with a prior misestimated x0.5
    (drift must trigger replans): replans, refits, the measured /
    predicted ratio, FID, outage, per bucket; executed logs monotone with
    no resurrection, images finite, one dispatch per batch run."""
    import numpy as np
    import torch
    from repro_torch.api import Provisioner
    from repro_torch.diffusion import unet
    ex = wl._ex()
    cfg = ex.cfg
    calls = unet.gn_silu_calls(cfg)
    rng = np.random.default_rng(22)
    shape = (cfg.image_size, cfg.image_size, cfg.in_channels)
    lat = {s.id: rng.standard_normal(shape).astype(np.float32)
           for s in scn.services}
    runs, executed = [], 0
    for label, scale in (("calibrated g", 1.0), ("prior g x 0.5", 0.5)):
        for eng in ("dict", "bucketed"):
            model = models[eng].scaled(scale)
            tag = f"closed {label} {eng}"
            t0 = time.perf_counter()
            rep, acc = _gn_run(ex, calls, tag, lambda: Provisioner(
                scn, workload=wl, scheduler="stacking", allocator="inv_se",
                delay=model, device="cuda", execute="closed",
                execute_kwargs={"exec_engine": eng}).run(latents=lat))
            wall = time.perf_counter() - t0
            res = rep.execution
            n = len(res.records)
            # the dict engine runs each batch eagerly; the bucketed one
            # replays a graph, eager only for a warm step before a capture
            ran = acc["graph_forwards"] if eng == "bucketed" \
                else acc["eager_forwards"]
            check(ran == n and res.session_telemetry["dispatches"] == n
                  and (eng == "dict" or
                       acc["eager_forwards"] <= acc["captures"]),
                  f"{tag}: {acc}, {res.session_telemetry['dispatches']} "
                  f"dispatches for {n} batches")
            seen = {}
            for _, k, steps in res.executed_log:
                check(steps == seen.get(k, 0) + 1,
                      f"{tag}: service {k} step {steps} after "
                      f"{seen.get(k, 0)}")
                seen[k] = steps
            times = [t for t, _, _ in res.executed_log]
            check(times == sorted(times), f"{tag}: log not monotone")
            for o in res.outcomes:
                img = res.content[o.id]
                check(seen.get(o.id, 0) == o.steps
                      and bool(np.isfinite(img).all()),
                      f"{tag}: service {o.id}")
                if o.steps == 0:
                    check(np.array_equal(img, lat[o.id]),
                          f"{tag}: service {o.id} ran no step but moved")
            if scale != 1.0:
                check(res.replans >= 1, f"{tag}: no replan under a x0.5 "
                      f"prior")
            ratio = res.wall_clock / res.predicted_wall()
            planned = res.wall_clock / res.predicted_wall(model)
            executed += acc["executed"]
            log(f"[closed] {label}, {eng}: planned with g = "
                f"{model.a * 1e3:.4f} ms * X + {model.b * 1e3:.4f} ms; "
                f"{n} batches, replans "
                f"{res.replans}, refits {res.refits}, wall_clock "
                f"{res.wall_clock:.4f} s / predicted_wall() "
                f"{res.predicted_wall():.4f} s = {ratio:.4f} (under the "
                f"planning model {planned:.4f}); mean FID "
                f"{res.mean_fid:.4f}, delivered FID "
                f"{res.delivered_fid:.4f}, outage {res.outage_rate:.1%}; "
                f"final g {res.delay.a * 1e3:.4f} ms * X + "
                f"{res.delay.b * 1e3:.4f} ms; whole run {wall:.3f} s")
            log(f"[closed]   per bucket: " + ", ".join(
                f"{b}: {v['batches']} x {v['mean_s'] * 1e3:.3f} ms "
                f"(predicted {v['predicted_s'] / v['batches'] * 1e3:.3f})"
                for b, v in sorted(res.per_bucket().items()))
                + f"; groupnorm_silu {acc['executed']} = {calls} x "
                f"{acc['eager_forwards'] + acc['graph_forwards']}")
            runs.append(dict(label=label, exec_engine=eng,
                             planning_a=model.a, planning_b=model.b,
                             batches=n,
                             replans=res.replans, refits=res.refits,
                             wall_clock=res.wall_clock,
                             predicted_wall=res.predicted_wall(),
                             ratio=ratio, ratio_planning_model=planned,
                             mean_fid=res.mean_fid,
                             delivered_fid=res.delivered_fid,
                             outage_rate=res.outage_rate,
                             per_bucket=res.per_bucket(), accounting=acc))
    torch.cuda.synchronize()
    return dict(runs=runs, launches=executed)


# ---------------------------------------------------------------------------
# The llm_decode path: full-width TinyLlama-1.1B through the port
# ---------------------------------------------------------------------------

LLM_PROMPT, LLM_MAX_LEN = 128, 512
LLM_WINDOW = 48                    # its start falls mid-tile in both kernels
LLM_PARITY_TOL = 2e-2              # logits, card vs CPU, bf16 KV cache,
                                   # relative to the largest |logit|
LLM_PARITY_STD = 0.02              # parity weights: Llama's init range
RMS_OPS_PER_ELEMENT = 4            # x*x+acc, /d+eps (per row), *rsqrt, *w


def _llm_ops():
    """Kernel name -> the module of its wrapper (of the same name)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.ssd_scan import ops as ssd
    return {"rmsnorm": rms, "flash_attention": fa, "decode_attention": dec,
            "ssd_scan": ssd}


def _plain_llm():
    """Kernel name -> its plain PyTorch version."""
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    return {"rmsnorm": rmsnorm_ref, "flash_attention": attention_ref,
            "decode_attention": decode_attention_ref,
            "ssd_scan": ssd_scan_ref}


def expected_launches(cfg, prefills: int, decodes: int):
    """Kernel launches of ``prefills`` prefills and ``decodes`` decode
    steps of ``cfg``: the transformer (dense and MoE: routing and the
    experts launch none of these kernels) has 2 RMSNorms per layer, 2
    more with per-head q/k norm (qwen3), and the final one per forward,
    an attention layer per layer; zamba2 has 2 RMSNorms per Mamba2
    layer, 2 per shared-block application and the final one, one
    ssd_scan per Mamba2 layer at prefill and the shared block's
    attention once per group."""
    L, n = cfg.num_layers, prefills + decodes
    if cfg.family == "hybrid":
        G = L // cfg.shared_attn_every
        return {"rmsnorm": (2 * L + 2 * G + 1) * n,
                "flash_attention": G * prefills,
                "decode_attention": G * decodes, "ssd_scan": L * prefills}
    norms = 2 * L + 1 + (2 * L if cfg.qk_norm else 0)
    return {"rmsnorm": norms * n, "flash_attention": L * prefills,
            "decode_attention": L * decodes, "ssd_scan": 0}


def _zero_llm_counts():
    for mod in _llm_ops().values():
        mod.launches = 0


def _llm_counts():
    return {name: mod.launches for name, mod in _llm_ops().items()}


def _dt(t):
    return str(t.dtype).replace("torch.", "")


@contextlib.contextmanager
def _swapped(make):
    """Put ``make(name, wrapper)`` in the place of each llm wrapper (the
    model's layers call them through their modules), and the wrappers
    back after."""
    ops = _llm_ops()
    real = {name: getattr(mod, name) for name, mod in ops.items()}
    for name, mod in ops.items():
        setattr(mod, name, make(name, real[name]))
    try:
        yield
    finally:
        for name, mod in ops.items():
            setattr(mod, name, real[name])


def _recording(seen, drop_batch=False):
    """Count each llm wrapper call in ``seen`` by (kernel, shapes and
    types of its tensor arguments of rank > 1), the batch dimension
    dropped or kept; the wrapper itself runs and counts its launch."""
    import torch
    lo = 1 if drop_batch else 0

    def make(name, fn):
        def record(*args, **kw):
            seen[(name, tuple((tuple(a.shape[lo:]), _dt(a)) for a in args
                              if isinstance(a, torch.Tensor)
                              and a.dim() > 1))] += 1
            return fn(*args, **kw)
        return record
    return _swapped(make)


def llm_shapes(cfg, params):
    """(kernel, per-row shapes and types) -> calls in one prefill of a
    LLM_PROMPT-token prompt plus one decode step against a LLM_MAX_LEN
    cache, recorded on the card with B=1: what one request costs each
    kernel on the provisioning path, the unit the kernels are timed in."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.models import api
    seen = collections.Counter()
    run = RunConfig()
    toks = torch.zeros((1, LLM_PROMPT), dtype=torch.int64, device="cuda")
    with _recording(seen, drop_batch=True):
        _, cache = api.make_prefill_step(cfg, run, LLM_MAX_LEN)(params, toks)
        api.make_decode_step(cfg, run)(params, toks[:, -1:], cache)
    return dict(sorted(seen.items()))


def _bound(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


F32_PEAK = "67 TFLOP/s f32 (CUDA cores)"
TC_PEAK = (f"{TF32_PER_F32_OP} x operations at 495 TFLOP/s TF32 (tensor "
           f"cores, 3xTF32)")


def flash_bound(q, k):
    """Bound of one causal flash_attention call, q (B,S,H,D) and k, v
    shaped like ``k``, ends aligned at Sq = Skv: q, o, k and v moved
    once at HBM_BYTES_PER_S against 4 D f32 operations per unmasked
    (query, key) pair, each TF32_PER_F32_OP tensor-core operations at
    TF32_OPS_PER_S.  Returns (ms, "bytes" or "operations", f32 ops)."""
    B, S, H, D = q.shape
    flops = 4 * D * (S * (S + 1) // 2) * B * H
    bound, by = _bound(_nbytes(q, q, k, k), TF32_PER_F32_OP * flops,
                       TF32_OPS_PER_S)
    return bound, by, flops


def ssd_bound(x, bmat, h0, chunk):
    """Bound of one ssd_scan call, x (B,S,H,P), bmat and cmat (B,S,N),
    h0 (B,H,P,N), chunks of Q = min(chunk, S): x, y, a (taken in x's
    type), B, C, h0 and h_final moved once at HBM_BYTES_PER_S, against
    the f32 operations, each TF32_PER_F32_OP tensor-core operations at
    TF32_OPS_PER_S (all four products run on 3xTF32).  Per (b, h) and
    chunk: 2QPN for C h^T and 2QPN for the state update; per causal (q,
    k) pair a decay multiply and 2P for the product with x.  The scores
    C B^T are the same for every head, so the function needs their 2N
    per pair once per batch row.  Returns (ms, "bytes" or "operations",
    f32 ops, bytes)."""
    B, S, H, P = x.shape
    N = bmat.shape[-1]
    Q = min(chunk, S)
    pairs = B * (S // Q) * Q * (Q + 1) // 2
    flops = (B * H * (S // Q) * 4 * Q * P * N + (2 * P + 1) * H * pairs
             + 2 * N * pairs)
    nb = (_nbytes(x, x, bmat, bmat, h0, h0)
          + B * S * H * x.element_size())
    bound, by = _bound(nb, TF32_PER_F32_OP * flops, TF32_OPS_PER_S)
    return bound, by, flops, nb


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _check_close(name, got, want, tol_key, err, tols=TOL):
    import torch
    got, want = got.float(), want.float()
    e = float((got - want).abs().max())
    err[tol_key] = max(err.get(tol_key, 0.0), e)
    tol = tols[tol_key]
    check(bool(torch.allclose(got, want, atol=tol, rtol=tol)),
          f"{name}: max abs err {e:.3g} over tolerance {tol}")


def _ssd_inputs(sig, randn):
    """Inputs of the SSD scan at ``sig`` (batch included), at the
    magnitudes of the reference's sweep (tests/test_kernels.py), where
    its tolerance of 3e-5 was set: a = -0.2 |N(0,1)|."""
    (xs, _), (as_, _), (bs, _), _, (hs, _) = sig
    return (randn(xs), -randn(as_).abs() * 0.2, randn(bs) * 0.3,
            randn(bs) * 0.3, randn(hs) * 0.1)


def _ssd_f64(x, a, b, c, h0):
    """The SSD recurrence step by step in float64 (the reference's
    sequential oracle, ssd_scan/ref.py): h_t = e^{a_t} h + x_t B_t^T,
    y_t = C_t h_t.  Returns y and the final state, float64."""
    import torch
    x, a, b, c = (t.double() for t in (x, a, b, c))
    h, ys = h0.double(), []
    for t in range(x.shape[1]):
        h = h * torch.exp(a[:, t])[..., None, None] \
            + x[:, t, :, :, None] * b[:, t, None, None, :]
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], h))
    return torch.stack(ys, dim=1), h


def _check_llm_kernel(name, sig, randn, rng, err):
    """The wrapper of ``name`` against its plain version at one call
    shape ``sig`` (batch included), fresh random inputs: float32,
    bfloat16 and (decode) f32 q over a bf16 cache; the attention kernels
    causal, at window 0 (the path's) and LLM_WINDOW; the SSD scan with
    h0 in float32 (SSD_TOL)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    run, plain = getattr(_llm_ops()[name], name), _plain_llm()[name]
    if name == "ssd_scan":
        x, a, b, c, h0 = _ssd_inputs(sig, randn)
        for dt in (f32, bf16):
            args = [t.to(dt) for t in (x, a, b, c)] + [h0]
            key = "bfloat16" if dt == bf16 else "float32"
            for got, want in zip(run(*args), plain(*args)):
                _check_close(f"ssd_scan {tuple(x.shape)} {dt}", got, want,
                             key, err, SSD_TOL)
        # the path's decays, a = dt * A = -softplus(N(0,1)) at A = -1:
        # -cum reaches ~100 in a chunk of 128, and an ulp of a float32
        # cum moves e^{cum_q - cum_k} by ~1e-5 (the plain version's cum
        # is float32, the kernel's float64).  Both are held to the
        # float64 recurrence; the kernel may be off by at most twice the
        # plain version (or 3e-5).
        a = -torch.nn.functional.softplus(randn(a.shape))
        exact = _ssd_f64(x, a, b, c, h0)
        off = {}
        for who, fn in (("kernel", run), ("plain", plain)):
            off[who] = max(float((got.double() - want).abs().max())
                           for got, want in zip(fn(x, a, b, c, h0), exact))
            key = f"path decays, {who} vs float64"
            err[key] = max(err.get(key, 0.0), off[who])
        check(off["kernel"] <= max(2 * off["plain"], SSD_TOL["float32"]),
              f"ssd_scan {tuple(x.shape)} at the path's decays: kernel "
              f"{off['kernel']:.3g} from float64, plain {off['plain']:.3g}")
    elif name == "rmsnorm":
        (xs, _), = sig
        x32 = randn(xs)
        for xd in (f32, bf16):
            for sd in (f32, bf16):
                x, w = x32.to(xd), randn(xs[-1:]).to(sd)
                _check_close(f"rmsnorm {xs} {xd}/{sd}", run(x, w),
                             plain(x, w),
                             "bfloat16" if bf16 in (xd, sd) else "float32",
                             err)
    elif name == "flash_attention":
        (qs, _), (ks, _), _ = sig
        q32, k32, v32 = randn(qs), randn(ks), randn(ks)
        for window in (0, LLM_WINDOW):
            for dt in (f32, bf16):
                q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
                _check_close(f"flash_attention {qs} {dt} w={window}",
                             run(q, k, v, window=window),
                             plain(q, k, v, window=window),
                             "bfloat16" if dt == bf16 else "float32", err)
    else:
        (qs, _), (cs, _), _ = sig
        q32, k32, v32 = randn(qs), randn(cs), randn(cs)
        cur = torch.tensor(rng.integers(1, cs[1] + 1, cs[0]),
                           dtype=torch.int32, device="cuda")
        for window in (0, LLM_WINDOW):
            for qd, cd in ((f32, f32), (bf16, bf16), (f32, bf16)):
                q, k, v = q32.to(qd), k32.to(cd), v32.to(cd)
                _check_close(f"decode_attention {qs} over {cs} {qd}/{cd} "
                             f"w={window}",
                             run(q, k, v, cur, window=window),
                             plain(q, k, v, cur, window=window),
                             "bfloat16" if bf16 in (qd, cd) else "float32",
                             err)


def _time_llm_kernel(name, sig, calls, randn, rng, B=8):
    """Device time of one call of ``name`` at per-row shape ``sig`` and
    batch B, in the path's types (f32 activations, bf16 cache): kernel,
    plain version, library yardstick, and the bound."""
    import torch
    import torch.nn.functional as F
    run, plain = getattr(_llm_ops()[name], name), _plain_llm()[name]
    if name == "ssd_scan":
        x, a, b, c, h0 = _ssd_inputs(
            tuple(((B,) + sh, t) for sh, t in sig), randn)
        S, H, P = sig[0][0]
        N = sig[2][0][-1]
        Q = min(128, S)                  # the chunk mamba2_forward asks
        bound, by, flops, nb = ssd_bound(x, b, h0, Q)
        return dict(kernel=name, shape=[B, *sig[0][0]], bc_shape=[B, S, N],
                    types="float32", calls=calls, chunk=Q, bound_ms=bound,
                    bound_by=by, peak=TC_PEAK, bytes=nb, flops=flops,
                    ms=device_time_ms(lambda: run(x, a, b, c, h0)),
                    plain_ms=device_time_ms(lambda: plain(x, a, b, c, h0)),
                    library_ms=None)
    if name == "rmsnorm":
        (xs, _), = sig
        x, w = randn((B,) + xs), randn(xs[-1:])
        nb = _nbytes(x, x, w)
        bound, by = _bound(nb, RMS_OPS_PER_ELEMENT * x.numel())
        p = _llm_ops()[name].plan(xs[-1], x.element_size())
        return dict(kernel=name, shape=[B, *xs], types="float32",
                    calls=calls, bound_ms=bound, bound_by=by, bytes=nb,
                    plan=dict(threads=p.threads, nv=p.nv, vec=p.vec,
                              chunks=p.chunks),
                    ms=device_time_ms(lambda: run(x, w)),
                    plain_ms=device_time_ms(lambda: plain(x, w)),
                    library_ms=device_time_ms(
                        lambda: F.rms_norm(x, xs[-1:], w, 1e-6)))
    if name == "flash_attention":
        (qs, _), (ks, _), _ = sig
        q, k, v = randn((B,) + qs), randn((B,) + ks), randn((B,) + ks)
        bound, by, flops = flash_bound(q, k)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return dict(kernel=name, shape=[B, *qs], kv_shape=[B, *ks],
                    types="float32", calls=calls, bound_ms=bound,
                    bound_by=by, peak=TC_PEAK,
                    bytes=_nbytes(q, q, k, v), flops=flops,
                    ms=device_time_ms(lambda: run(q, k, v)),
                    plain_ms=device_time_ms(lambda: plain(q, k, v)),
                    library_ms=device_time_ms(
                        lambda: F.scaled_dot_product_attention(
                            qt, kt, vt, is_causal=True, enable_gqa=True)))
    (qs, _), (cs, _), _ = sig
    S, KV, D = cs
    H = qs[1]
    q = randn((B,) + qs)
    kb = randn((B,) + cs).to(torch.bfloat16)
    vb = randn((B,) + cs).to(torch.bfloat16)
    cur = torch.tensor(rng.integers(1, S + 1, B), dtype=torch.int32,
                       device="cuda")
    valid = int(cur.clamp(max=S).sum())
    nb = _nbytes(q, q, cur) + 2 * valid * KV * D * kb.element_size()
    bound, by = _bound(nb, 4 * D * H * valid)
    qt = q.to(torch.bfloat16).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (kb, vb))
    mask = (torch.arange(S, device="cuda")[None]
            < cur[:, None])[:, None, None, :]
    splits = _llm_ops()[name].num_splits(B, KV, S)
    return dict(kernel=name, shape=[B, *qs], cache_shape=[B, *cs],
                splits=splits, grid=[splits, KV, B],
                types="float32 q, bfloat16 cache", calls=calls,
                cur_len=cur.tolist(), bound_ms=bound, bound_by=by,
                bytes=nb, flops=4 * D * H * valid,
                ms=device_time_ms(lambda: run(q, kb, vb, cur)),
                plain_ms=device_time_ms(lambda: plain(q, kb, vb, cur)),
                library_ms=device_time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)))


LLM_SOURCES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:27",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:86",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:73",
    "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:76"}
NO_LIBRARY = {"ssd_scan": "no single PyTorch call computes the chunked SSD "
                          "scan"}


def _fmt_us(ms):
    return "      n/a" if ms is None else f"{ms * 1e3:9.2f}"


def phase_llm_kernels(cfg, shapes, seen, card):
    """Each kernel of ``cfg``'s path against its plain version at every
    call shape the main path gave it (``seen``: calibration at batch
    1..16 and prompt min(32, max_len - 2), provisioning at prompt
    LLM_PROMPT), and at the one-request shapes (``shapes``) with B in
    {1, 8}; then times at B=8 per one-request shape: kernel, plain
    version, library yardstick, bound.  Returns {kernel: summary} and
    the timed rows."""
    import numpy as np
    import torch
    gen = torch.Generator(device="cuda").manual_seed(21)
    rng = np.random.default_rng(21)
    tag = f"[llm-kernels {cfg.name}]"

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda")
    todo = set(seen) | {(name, tuple(((B,) + s, t) for s, t in sig))
                        for name, sig in shapes for B in (1, 8)}
    names = sorted({name for name, _ in shapes})
    errs = {name: {} for name in names}
    done = collections.defaultdict(list)
    for name, sig in sorted(todo):
        _check_llm_kernel(name, sig, randn, rng, errs[name])
        done[name].append(sig[0][0])
    torch.cuda.synchronize()
    check(set(done) == set(errs), f"kernels checked: {sorted(done)}")
    for name, e in errs.items():
        tols = SSD_TOL if name == "ssd_scan" else TOL
        batches = sorted({s[0] for s in done[name]})
        rows = sorted({s[1:] for s in done[name]})
        log(f"{tag} {name}: {len(done[name])} call shapes (B in "
            f"{batches}, per row {rows}) match the plain version: max abs "
            f"err " + ", ".join(f"{k} {v:.3g} (tol {tols.get(k, 'none')})"
                                for k, v in sorted(e.items())))
    rows = [dict(_time_llm_kernel(name, sig, calls, randn, rng),
                 model=cfg.name)
            for (name, sig), calls in shapes.items()]
    log(f"{tag} B=8, device time per call (CUDA graph, L2-warm) on {card}; "
        "library: F.rms_norm, F.scaled_dot_product_attention (decode: bf16 "
        "q, boolean cur_len mask), none for ssd_scan")
    for r in rows:
        log(f"{tag} {r['kernel']:>16} {str(tuple(r['shape'])):>18} "
            f"x{r['calls']:<2} kernel {_fmt_us(r['ms'])} us  plain "
            f"{_fmt_us(r['plain_ms'])} us  library "
            f"{_fmt_us(r['library_ms'])} us  bound "
            f"{r['bound_ms'] * 1e3:8.2f} us ({r['bound_by']}; "
            f"operations at {r.get('peak', F32_PEAK)})  "
            f"bound/kernel {r['bound_ms'] / r['ms']:.3f}"
            + (f"  splits {r['splits']}, grid {tuple(r['grid'])}"
               if "splits" in r else "")
            + ("  plan: threads {threads} nv {nv} vec {vec} chunks "
               "{chunks}".format(**r["plan"]) if "plan" in r else ""))
    summaries = {}
    for name in names:
        mine = [r for r in rows if r["kernel"] == name]

        def total(key, mine=mine):
            if any(r[key] is None for r in mine):
                return None
            return sum(r[key] * r["calls"] for r in mine)
        e = errs[name]
        summaries[name] = dict(
            max_abs_err=e.get("float32", 0.0),
            max_abs_err_bf16=e.get("bfloat16", 0.0),
            ms=total("ms"), plain_ms=total("plain_ms"),
            bound_ms=total("bound_ms"),
            bound_by="bytes" if all(r["bound_by"] == "bytes" for r in mine)
            else "operations",
            library_ms=total("library_ms"),
            checked_shapes=[list(s) for s in done[name]],
            timed_as=f"{cfg.name}: sum over its calls in one prefill "
                     f"(prompt {LLM_PROMPT}) + one decode step (cache "
                     f"{LLM_MAX_LEN}) at B=8, the path's types")
    return summaries, rows


def merge_kernel_summaries(per_model):
    """{model: {kernel: summary with launches}} -> one entry per kernel
    for the result line: launches summed over the models' main paths,
    the largest error, times summed over the models' timed units (each
    model's entry kept under ``by_model``)."""
    out = []
    for name, replaces in LLM_SOURCES.items():
        parts = {m: k[name] for m, k in per_model.items() if name in k}
        check(bool(parts), f"{name}: no path ran it")

        def add(key, parts=parts):
            vals = [p[key] for p in parts.values()]
            return None if None in vals else sum(vals)
        out.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces,
            launches=add("launches"),
            max_abs_err=max(p["max_abs_err"] for p in parts.values()),
            max_abs_err_bf16=max(p["max_abs_err_bf16"]
                                 for p in parts.values()),
            ms=add("ms"), plain_ms=add("plain_ms"),
            bound_ms=add("bound_ms"),
            bound_by="bytes" if all(p["bound_by"] == "bytes"
                                    for p in parts.values())
            else "operations",
            library_ms=add("library_ms"),
            **({"library_none": NO_LIBRARY[name]} if name in NO_LIBRARY
               else {}),
            timed_as="sum over " + "; ".join(p["timed_as"]
                                             for p in parts.values()),
            by_model=parts))
    return out


def phase_llm_main(cfg, params, card, K: int = 8):
    """Full-width ``cfg`` through the port's Provisioner: calibrate
    g(X), a K-request scenario, inv_se -> stacking -> validate -> simulate ->
    timed execute.  Kernel counts are zeroed before and read after, and
    every wrapper call is recorded by its shapes and types (a Counter
    update per call, against ~40 us of host time per wrapper call), so
    phase llm-kernels checks each kernel at the shapes this run gave it."""
    import numpy as np
    import torch
    from repro_torch.api import DecodeWorkload, Provisioner
    from repro_torch.core.delay_model import DelayModel, fit
    from repro_torch.core.service import Scenario, ServiceRequest
    tag = f"[llm-main {cfg.name}]"
    n_params = sum(int(np.prod(p.shape)) for p in _leaves(params))
    wl = DecodeWorkload(cfg=cfg, params=params, max_len=LLM_MAX_LEN,
                        prompt_len=LLM_PROMPT, device="cuda")
    eng = wl._eng()
    log(f"{tag} {n_params} params (seeded random, "
        f"float32 on the card), KV cache {wl.run.kv_cache_dtype}, prompt "
        f"{LLM_PROMPT}, max_len {LLM_MAX_LEN}")
    seen = collections.Counter()
    sizes, reps = (1, 2, 4, 8, 16), 5
    _zero_llm_counts()
    p0, d0 = eng.prefill_calls, eng.decode_calls
    with _recording(seen):
        curve = wl.measure_delay_curve(batch_sizes=sizes, reps=reps)
    cal = _llm_counts()
    cal_prefills = eng.prefill_calls - p0
    cal_decodes = eng.decode_calls - d0
    check(cal_prefills == len(sizes)
          and cal_decodes == len(sizes) * (1 + reps),
          f"calibration made {cal_prefills} prefills and {cal_decodes} "
          f"decode steps")
    check(cal == expected_launches(cfg, cal_prefills, cal_decodes),
          f"calibration launches {cal}")
    raw = fit([c[0] for c in curve], [c[1] for c in curve])
    # the reference's refit floor (DelayModel.refit), as for the U-Net
    g = DelayModel(a=max(raw.a, 1e-9), b=max(raw.b, 1e-9))
    log(f"{tag} decode delay curve (batch, best-of-{reps} s per "
        f"step): " + ", ".join(f"{x}: {s * 1e3:.3f} ms" for x, s in curve))
    log(f"{tag} fitted g(X) = {raw.a * 1e3:.4f} ms * X + "
        f"{raw.b * 1e3:.4f} ms on {card}; planning with a = "
        f"{g.a * 1e3:.4f} ms, b = {g.b * 1e3:.4f} ms")
    multiples = np.linspace(10.0, 40.0, K)
    scn = Scenario(services=[
        ServiceRequest(id=k, deadline=float(multiples[k] * g.g(K) + 0.05),
                       spectral_eff=7.0) for k in range(K)],
        total_bandwidth_hz=40_000.0, content_bits=512.0)
    _zero_llm_counts()
    p0, d0 = eng.prefill_calls, eng.decode_calls
    t0 = time.perf_counter()
    with _recording(seen):
        rep = Provisioner(scn, workload=wl, scheduler="stacking",
                          allocator="inv_se", delay=g, device="cuda").run(
            timed=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _llm_counts()
    prefills, decodes = eng.prefill_calls - p0, eng.decode_calls - d0
    plan = rep.plan
    check(decodes == plan.num_batches,
          f"{decodes} decode steps for {plan.num_batches} batches")
    check(launches == expected_launches(cfg, prefills, decodes),
          f"main path launches {launches} for {prefills} prefills and "
          f"{decodes} decode steps")
    steps = [plan.steps_completed[k] for k in range(K)]
    check(min(steps) > 0, f"a request got no tokens: {steps}")
    for k, toks in rep.content.items():
        check(len(toks) == plan.steps_completed[k]
              and all(0 <= t < cfg.vocab_size for t in toks),
              f"request {k}: {len(toks)} tokens, planned "
              f"{plan.steps_completed[k]}")
    via_executor, ex_launches = None, {k: 0 for k in launches}
    if cfg.family != "hybrid":
        # the same plan again through the "llm_decode" entry of EXECUTORS
        # (open loop, timed per batch): the same tokens
        from repro_torch.api import execute_plan
        _zero_llm_counts()
        p0, d0 = eng.prefill_calls, eng.decode_calls
        with _recording(seen):
            res = execute_plan(scn, plan, rep.allocation, wl, mode="open",
                               delay=g)
        torch.cuda.synchronize()
        ex_launches = _llm_counts()
        ex_prefills = eng.prefill_calls - p0
        ex_decodes = eng.decode_calls - d0
        check(ex_decodes == plan.num_batches == len(res.records)
              and ex_launches == expected_launches(cfg, ex_prefills,
                                                   ex_decodes),
              f"execute_plan: {ex_launches} launches for {ex_prefills} "
              f"prefills and {ex_decodes} decode steps")
        check(res.content == rep.content,
              "execute_plan's tokens differ from the Provisioner's")
        log(f"{tag} execute_plan(mode='open') through EXECUTORS"
            f"['llm_decode']: {len(res.records)} batches, tokens equal "
            f"to the Provisioner's; wall_clock {res.wall_clock:.4f} s / "
            f"predicted_wall() {res.predicted_wall():.4f} s = "
            f"{res.wall_clock / res.predicted_wall():.4f}; launches "
            f"{ex_launches}")
        via_executor = dict(batches=len(res.records),
                            wall_clock=res.wall_clock,
                            predicted_wall=res.predicted_wall(),
                            launches=ex_launches)
    measured = sum(s for _, s in rep.timings)
    predicted = plan.makespan()
    tokens = sum(steps)
    log(f"{tag} K={K}: {plan.num_batches} batches, sizes "
        f"{dict(sorted(collections.Counter(plan.batch_sizes()).items()))}, "
        f"tokens per request {steps}, {prefills} prefill call(s)")
    log(f"{tag} mean TokenQuality {rep.mean_fid:.4f}, outage "
        f"{rep.outage_rate:.1%}; decode measured {measured:.4f} s (sum of "
        f"timed batches), predicted {predicted:.4f} s (plan makespan under "
        f"the fit), measured/predicted {measured / predicted:.4f}; "
        f"{tokens / measured:.1f} tokens/s; whole run {wall:.3f} s")
    log(f"{tag} launches: calibration {cal}, provisioning {launches} "
        f"= per prefill {expected_launches(cfg, 1, 0)} and per decode step "
        f"{expected_launches(cfg, 0, 1)}; {len(seen)} distinct call shapes")
    return dict(n_params=n_params, curve=curve, fit_a=raw.a, fit_b=raw.b,
                a=g.a, b=g.b, K=K, batches=plan.num_batches,
                batch_sizes=plan.batch_sizes(), steps=steps,
                mean_quality=rep.mean_fid, outage_rate=rep.outage_rate,
                measured_s=measured, predicted_s=predicted,
                tokens_per_s=tokens / measured, wall_s=wall,
                prefills=prefills, decodes=decodes,
                execute_plan=via_executor,
                calibration_launches=cal, provision_launches=launches,
                launches={k: cal[k] + launches[k] + ex_launches[k]
                          for k in launches}), wl, seen


def phase_llm_trace(wl, card, batch: int = 8, steps: int = 5):
    """Where one decode step's time goes at ``batch`` (prompt
    LLM_PROMPT): torch.profiler for device time by kernel, the same steps
    unprofiled for wall time; host time of one call of each wrapper."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ops = _llm_ops()
    eng = wl._eng()
    cfg = eng.cfg
    tag = f"[llm-trace {cfg.name}]"
    toks = np.random.default_rng(3).integers(
        0, eng.cfg.vocab_size, (batch, LLM_PROMPT)).astype(np.int32)
    _, cache = eng.prefill(toks)
    tok = torch.zeros((batch, 1), dtype=torch.int64, device="cuda")
    eng.decode(tok, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.decode(tok, cache)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            eng.decode(tok, cache)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    dev = {e.key: e.self_device_time_total / steps for e in events}
    launches = sum(e.count for e in events) / steps
    device_us = sum(dev.values())
    busy = device_us / wall_us

    def share(pattern):
        return sum(v for k, v in dev.items() if pattern in k)
    ours = {"rmsnorm": share("rmsnorm_kernel"),
            "decode_attention": share("decode_split_kernel")
            + share("decode_combine_kernel")}
    log(f"{tag} on {card}, one decode step at batch {batch}, cache "
        f"{LLM_MAX_LEN}, position {LLM_PROMPT}: wall {wall_us:.0f} us "
        f"(unprofiled), device busy {device_us:.0f} us = {busy:.1%} of "
        f"wall, idle {1 - busy:.1%}; {launches:.0f} kernels per step; "
        + ", ".join(f"{k} {v:.0f} us" for k, v in ours.items()))
    for k, v in sorted(dev.items(), key=lambda kv: -kv[1])[:8]:
        log(f"{tag}   {v:9.1f} us/step  {k[:90]}")
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    x = torch.randn((batch, 1, cfg.d_model), device="cuda")
    w = torch.ones(cfg.d_model, device="cuda")
    q = torch.randn((1, 16, H, D), device="cuda")
    kv = torch.randn((1, 16, KV, D), device="cuda")
    qd = torch.randn((batch, 1, H, D), device="cuda")
    cd = torch.randn((batch, LLM_MAX_LEN, KV, D), device="cuda").to(
        torch.bfloat16)
    cur = torch.full((batch,), LLM_PROMPT, dtype=torch.int32, device="cuda")
    host = {}
    for name, fn in (("rmsnorm wrapper",
                      lambda: ops["rmsnorm"].rmsnorm(x, w)),
                     ("flash_attention wrapper",
                      lambda: ops["flash_attention"].flash_attention(
                          q, kv, kv)),
                     ("decode_attention wrapper",
                      lambda: ops["decode_attention"].decode_attention(
                          qd, cd, cd, cur)),
                     ("torch.add", lambda: x + 1.0)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host[name] = (time.perf_counter() - t0) * 1e6 / 200
        torch.cuda.synchronize()
    log(f"{tag} host us per call (200 calls, no sync): "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    return dict(batch=batch, wall_us=wall_us, device_us=device_us,
                busy=busy, launches_per_step=launches, ours_us=ours,
                top=sorted(dev.items(), key=lambda kv: -kv[1])[:8],
                host_us_per_call=host)


def _greedy_logits(cfg, params, prompt, tokens, device):
    """Logits of each decode step when ``prompt`` is followed by
    ``tokens`` (the engine's order: prompt[-1] is re-fed first)."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.models import api
    run = RunConfig()
    p = torch.as_tensor(prompt[None].astype("int64"), device=device)
    _, cache = api.make_prefill_step(cfg, run, LLM_MAX_LEN)(params, p)
    step = api.make_decode_step(cfg, run)
    out, tok = [], p[:, -1:]
    for t in tokens:
        logits, cache = step(params, tok, cache)
        out.append(logits[0, -1].cpu())
        tok = torch.tensor([[t]], device=device)
    return out


def parity_params(cfg):
    """Full-width params for the parity phase: every random leaf normal
    with std LLM_PARITY_STD (norm scales 1), drawn on the card.

    The reference's init (``fan_in = shape[-2]``, copied as it is) gives
    wq a fan_in of H and wk one of KV: q has std sqrt(d/H) = 8, k
    sqrt(d/KV) = 22.6, so attention scores have a std of ~180 and each
    softmax is one-hot.  Rounding then decides which key wins, and the
    logits of two correct computations part by O(1) (``logit_witness``
    measures it).  At std 0.02 the scores are O(1) and the comparison
    measures the kernels.  The model's own schema; zamba2's conv weights
    (pinned at 0.5 in the reference) are drawn at std 0.02 too."""
    import torch
    from repro_torch.models import api
    from repro_torch.models.params import P, init_params, map_schema
    sch = map_schema(lambda p, _: p if p.init in ("ones", "zeros")
                     else P(p.shape, scale=LLM_PARITY_STD),
                     api.get_model(cfg).schema(cfg))
    return init_params(sch, torch.Generator(device="cuda").manual_seed(5),
                       "cuda")


def logit_witness(cfg, params, cpu_params, label):
    """The first decode step's logits (a 16-token prompt from seed 9)
    four ways on the same params: the card with the kernels, the card
    with the plain versions in their place (the same cuBLAS matmuls),
    the CPU, and the CPU with every token-embedding entry moved by one
    ulp in a random direction.  Where one ulp of input moves the CPU's
    own logits about as far as the card's differ from the CPU's, the
    params make the logits a matter of rounding, whatever computes
    them.  Reported, not gated."""
    import numpy as np
    import torch
    prompt = np.random.default_rng(9).integers(
        0, cfg.vocab_size, 16).astype(np.int32)

    def first(p, device):
        return _greedy_logits(cfg, p, prompt, [0], device)[0]
    out = {"card": first(params, "cuda")}
    with _swapped(lambda name, _: _plain_llm()[name]):
        out["card_plain"] = first(params, "cuda")
    out["cpu"] = first(cpu_params, "cpu")
    tok = cpu_params["embed"]["tok"]
    up = torch.rand(tok.shape, generator=torch.Generator().manual_seed(13))
    moved = torch.nextafter(tok, torch.where(up < 0.5, math.inf, -math.inf))
    out["cpu_ulp"] = first(dict(cpu_params, embed=dict(
        cpu_params["embed"], tok=moved)), "cpu")
    gaps = {f"{a} vs {b}": float((out[a] - out[b]).abs().max())
            for a, b in (("card", "cpu"), ("card_plain", "cpu"),
                         ("card", "card_plain"), ("cpu_ulp", "cpu"))}
    argmax = {k: int(v.argmax()) for k, v in out.items()}
    scale = float(out["cpu"].abs().max())
    log(f"[llm-witness {cfg.name}] {label}: first decode step logits, "
        f"|logit| <= "
        f"{scale:.3g}; max abs gap "
        + ", ".join(f"{k} {v:.3g}" for k, v in gaps.items())
        + f"; argmax {argmax}")
    return dict(label=label, scale=scale, gaps=gaps, argmax=argmax)


def phase_llm_parity(cfg, layers=None):
    """K=2, prompt 16, 4 tokens each, through DecodeWorkload on the card
    (kernels) and on the CPU (plain versions), same params
    (``parity_params``): the greedy tokens and the first decode step's
    logits; then ``logit_witness`` on these params.  ``layers``: cut the
    depth (full width) so that the CPU holds the model.  MoE: the routing
    flips of the first decode step's forwards are reported, and its
    logits are gated only where no expert choice flipped (one flip moves
    a token's output by far more than the tolerance)."""
    import torch
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    from repro_torch.api import DecodeWorkload
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.plan import BatchPlan
    tag = f"[llm-parity {cfg.name}]"
    prompt_len, n = 16, 4
    plan = BatchPlan(batches=[[(0, i), (1, i)] for i in range(n)],
                     start_times=[float(i) for i in range(n)],
                     steps_completed={0: n, 1: n}, delay=DelayModel())
    params = parity_params(cfg)
    cpu_params = _tree_to(params, "cpu")
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        wl = DecodeWorkload(cfg=cfg, params=p, max_len=LLM_MAX_LEN,
                            prompt_len=prompt_len, device=dev)
        before = _llm_counts()
        out[dev] = wl.execute(plan).content
        if dev == "cuda":
            after = _llm_counts()
            check(after["decode_attention"] - before["decode_attention"]
                  == expected_launches(cfg, 0, n)["decode_attention"],
                  "parity run on the card did not launch decode_attention "
                  "per attention layer and step")
        prompts = {k: wl._prompt(k, cfg.vocab_size) for k in (0, 1)}
    first = {dev: _greedy_logits(cfg, p, prompts[0], [0], dev)[0]
             for dev, p in (("cuda", params), ("cpu", cpu_params))}
    err = float((first["cuda"] - first["cpu"]).abs().max())
    scale = float(first["cpu"].abs().max())
    tol = LLM_PARITY_TOL * scale
    routing = None
    if cfg.is_moe:
        flips, total, margin = routing_flips(cfg, params, cpu_params,
                                             prompts[0])
        routing = dict(flips=flips, choices=total, min_top_k_margin=margin)
        log(f"{tag} routing of request 0's prefill and first decode step "
            f"over {cfg.num_layers} layers: {flips} of {total} (b, s, k) "
            f"expert choices differ, card vs CPU; smallest margin between "
            f"the K-th and (K+1)-th probability on the CPU {margin:.3g}")
    if routing is None or routing["flips"] == 0:
        check(err <= tol, f"first decode step logits, card vs CPU: max "
              f"abs err {err:.3g} over {tol:.3g} = {LLM_PARITY_TOL} x the "
              f"largest |logit| {scale:.3g}")
    else:
        log(f"{tag} first decode step logits not gated: a routing choice "
            f"flipped (max abs err {err:.3g}, tolerance {tol:.3g})")
    margins = []
    for k in (0, 1):
        a, b = out["cuda"][k], out["cpu"][k]
        if a == b:
            continue
        i = next(j for j in range(n) if a[j] != b[j])
        logits = _greedy_logits(cfg, cpu_params, prompts[k], b[:i + 1],
                                "cpu")[i]
        top2 = torch.topk(logits, 2).values
        margin = float(top2[0] - top2[1])
        margins.append(dict(request=k, step=i, margin=margin))
        log(f"{tag} request {k} differs at token {i}: card "
            f"{a[i]}, CPU {b[i]}; CPU top-2 logit margin {margin:.3g}")
        check(margin <= tol,
              f"request {k}: tokens differ at step {i} with a top-2 "
              f"margin {margin:.3g} over the logits tolerance {tol:.3g}")
    log(f"{tag} K=2, prompt {prompt_len}, {n} tokens each: card "
        f"{out['cuda']}, CPU {out['cpu']} "
        f"({'equal' if not margins else 'differ within the margin'}); "
        f"first decode step logits max abs err {err:.3g} at |logit| <= "
        f"{scale:.3g} (tolerance {LLM_PARITY_TOL} x {scale:.3g}); weights "
        f"normal(0, {LLM_PARITY_STD})")
    witness = logit_witness(cfg, params, cpu_params,
                            f"weights normal(0, {LLM_PARITY_STD})")
    return dict(tokens_card=out["cuda"], tokens_cpu=out["cpu"],
                logits_max_abs_err=err, logits_scale=scale,
                tol=tol, margins=margins, weight_std=LLM_PARITY_STD,
                witness=witness, layers=cfg.num_layers, routing=routing)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def llm_path(card, cfg, K: int = 8, trace: bool = True):
    """The llm_decode path on full-width ``cfg`` with f32 weights drawn
    on the card: the calls of one request, phase llm-main with K
    requests, llm-kernels and (``trace``) llm-trace.  Returns its
    kernels' {name: summary with launches}, the details (with the init
    seconds and the peak device memory from the draw on) and the
    params."""
    import torch
    from repro_torch.models import api
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_model(cfg,
                            torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[llm {cfg.name}] {cfg.num_layers} layers, params drawn on the "
        f"card in {init_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    shapes = llm_shapes(cfg, params)
    per = collections.Counter()
    for (name, _), n in shapes.items():
        per[name] += n
    want = {k: v for k, v in expected_launches(cfg, 1, 1).items() if v}
    check(dict(per) == want,
          f"one prefill + one decode step made {dict(per)} kernel calls, "
          f"expected {want}")
    main_path, wl, seen = phase_llm_main(cfg, params, card, K=K)
    summaries, rows = phase_llm_kernels(cfg, shapes, seen, card)
    for name, s in summaries.items():
        s["launches"] = main_path["launches"][name]
    details = dict(kernel_rows=rows, main=main_path, layers=cfg.num_layers,
                   init_s=init_s)
    if trace:
        details["trace"] = phase_llm_trace(wl, card)
    del wl
    details["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"[llm {cfg.name}] peak device memory {details['peak_gib']:.2f} "
        f"GiB (max_memory_allocated from the draw on) on {card}")
    return summaries, details, params


def phase_llm(card, cfg):
    """The llm_decode path on full-width ``cfg`` (``llm_path``), then
    the witness on the reference's init and phase llm-parity: its
    kernels' {name: summary with launches} and the phase's details."""
    import torch
    summaries, details, params = llm_path(card, cfg)
    chaos = logit_witness(cfg, params, _tree_to(params, "cpu"),
                          "reference init")
    del params
    torch.cuda.empty_cache()
    details["parity"] = phase_llm_parity(cfg)
    details["parity"]["reference_init_witness"] = chaos
    torch.cuda.empty_cache()
    return summaries, details


# ---------------------------------------------------------------------------
# The MoE family: deepseek-moe-16b and qwen3-moe-30b-a3b at full width
# ---------------------------------------------------------------------------

MOE_QWEN3_LAYERS = 8               # of 48: the full depth is 122 GB in f32
MOE_PARITY_LAYERS = 2
MOE_LAUNCHER = ("--arch", "deepseek-moe-16b", "--requests", "6")
MOE_LAUNCHER_TIMEOUT = 600


def _moe_probs(cfg, params, prompt, device):
    """The router probabilities (float32, on the CPU) of every MoE call
    in a prefill of ``prompt`` and the first decode step, in call
    order."""
    import torch
    from repro_torch.models import transformer
    real, rec = transformer.apply_moe, []

    def spy(cfg_, p, x, **kw):
        rec.append(torch.softmax(x.float() @ p["router"].float(),
                                 dim=-1).cpu())
        return real(cfg_, p, x, **kw)
    transformer.apply_moe = spy
    try:
        _greedy_logits(cfg, params, prompt, [0], device)
    finally:
        transformer.apply_moe = real
    return rec


def routing_flips(cfg, params, cpu_params, prompt):
    """Expert choices of the card against the CPU over every MoE call of
    a prefill of ``prompt`` and the first decode step, each device
    ranking its own probabilities (top-K, ties to the lower index):
    (flipped (b, s, k) choices, all choices, the smallest margin between
    the K-th and the (K+1)-th probability on the CPU)."""
    import torch
    K = cfg.experts_per_token
    card = _moe_probs(cfg, params, prompt, "cuda")
    cpu = _moe_probs(cfg, cpu_params, prompt, "cpu")
    check(len(card) == len(cpu) == 2 * cfg.num_layers,
          f"{len(card)} / {len(cpu)} MoE calls")
    flips = total = 0
    margin = math.inf
    for a, b in zip(card, cpu):
        ia = torch.sort(a, dim=-1, descending=True, stable=True)[1][..., :K]
        vb, ib = torch.sort(b, dim=-1, descending=True, stable=True)
        flips += int((ia != ib[..., :K]).sum())
        total += ia.numel()
        margin = min(margin, float((vb[..., K - 1] - vb[..., K]).min()))
    return flips, total, margin


def phase_moe(card):
    """Phase moe: (a) full-width, full-depth deepseek-moe-16b through
    the Provisioner (``llm_path``, K=8, traced); (c) qwen3-moe-30b-a3b at
    full width and MOE_QWEN3_LAYERS layers (K=2), q/k norm over rows of
    128 and G=8 at D=128; (b) every kernel at every shape (a) and (c)
    gave it, inside ``llm_path``; (d) phase llm-parity on deepseek at
    MOE_PARITY_LAYERS layers with routing flips reported; (e) the serve
    launcher on full-width deepseek in a child process.  Returns the
    kernels' {model: {name: summary with launches}} and the details."""
    import torch
    from repro_torch.configs.deepseek_moe_16b import CONFIG as DEEPSEEK
    from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    log(f"[moe] before deepseek-moe-16b: "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved on {card}")
    per_model, details = {}, {}
    qwen3 = dataclasses.replace(QWEN3, num_layers=MOE_QWEN3_LAYERS)
    for cfg, K, trace in ((DEEPSEEK, 8, True), (qwen3, 2, False)):
        label = f"{cfg.name} ({cfg.num_layers} layers)"
        per_model[label], details[label], params = llm_path(
            card, cfg, K=K, trace=trace)
        del params
        torch.cuda.empty_cache()
    details["parity"] = phase_llm_parity(DEEPSEEK, layers=MOE_PARITY_LAYERS)
    torch.cuda.empty_cache()
    details["launcher"] = moe_launcher(card)
    details["seconds"] = time.perf_counter() - t_phase
    log(f"[done] phase moe {details['seconds']:.1f} s on {card}")
    return per_model, details


def moe_launcher(card):
    """``python -m repro_torch.launch.serve`` with MOE_LAUNCHER in a
    child process on the card this process has released: exit 0, a
    line per request with its tokens, both quality penalties."""
    import re
    import torch
    torch.cuda.empty_cache()
    log(f"[moe-launcher] this process holds "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *MOE_LAUNCHER]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=MOE_LAUNCHER_TIMEOUT)
    secs = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        if line.strip():
            log(f"[moe-launcher] | {line}")
    check(proc.returncode == 0, f"{' '.join(cmd[1:])} exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    rows = [m.groups() for m in re.finditer(
        r"^ *(\d+) +([\d.]+) +(\d+)  \[([\d, ]*)\]$", proc.stdout, re.M)]
    pen = re.search(r"mean quality penalty: stacking=([\d.]+) "
                    r"greedy=([\d.]+)", proc.stdout)
    n = int(MOE_LAUNCHER[MOE_LAUNCHER.index("--requests") + 1])
    check(len(rows) == n and pen is not None,
          f"the launcher printed {len(rows)} request rows of {n} and "
          f"{'no' if pen is None else 'its'} quality penalties")
    for rid, _, count, toks in rows:
        check(len([t for t in toks.split(",") if t.strip()]) == int(count),
              f"request {rid}: {count} tokens, printed {toks!r}")
    log(f"[moe-launcher] {' '.join(cmd[1:])}: exit 0 in {secs:.1f} s on "
        f"{card}; tokens per request {[int(r[2]) for r in rows]}; mean "
        f"quality penalty stacking {pen.group(1)}, greedy {pen.group(2)}")
    return dict(cmd=cmd[1:], seconds=secs,
                tokens=[int(r[2]) for r in rows],
                penalty_stacking=float(pen.group(1)),
                penalty_greedy=float(pen.group(2)))


# ---------------------------------------------------------------------------
# Training: full-width TinyLlama-1.1B train steps through the kernels
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 512, 5, 1e-3
TRAIN_REMAT_STEPS = 2
TRAIN_PARITY = dict(layers=2, batch=2, seq=128)
TRAIN_LOSS_TOL = 1e-4          # card vs CPU loss, relative
TRAIN_GRAD_TOL = 1e-3          # card vs CPU grads, x the leaf's max |g|
TRAIN_REMAT_TOL = 1e-6         # remat vs not, grads, x the leaf's max |g|
TRAIN_KERNELS = ("rmsnorm", "flash_attention")


def _train_data(cfg, batch, seq):
    from repro_torch.training.data import DataConfig, batches
    return batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                              global_batch=batch, seed=0))


def _leaf_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaf_items(tree[k], f"{prefix}{k}/")]
    return [(prefix.rstrip("/"), tree)]


def _loss_and_grads(cfg, params, toks, labels, run):
    """Loss of one batch and each leaf's gradient (as left in .grad)."""
    import torch
    from repro_torch.training import train
    train.trainable(params)
    for _, p in _leaf_items(params):
        p.grad = None
    dev = _leaf_items(params)[0][1].device
    loss, _ = train.make_loss_fn(cfg, run)(
        params, torch.as_tensor(toks, device=dev),
        torch.as_tensor(labels, device=dev))
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in _leaf_items(params)}


def train_parity(cfg, seen):
    """TinyLlama at full width, TRAIN_PARITY["layers"] layers, std-0.02
    weights (``parity_params``): loss and every leaf's gradient of one
    batch on the card (the kernels' Functions) and on the CPU (plain
    versions).  Kernel calls are recorded by shape in ``seen``."""
    import torch
    from repro_torch.config import RunConfig
    small = dataclasses.replace(cfg, num_layers=TRAIN_PARITY["layers"])
    params = parity_params(small)
    cpu_params = _tree_to(params, "cpu")
    toks, labels = next(_train_data(small, TRAIN_PARITY["batch"],
                                    TRAIN_PARITY["seq"]))
    before = _llm_counts()
    with _recording(seen):
        loss_card, g_card = _loss_and_grads(small, params, toks, labels,
                                            RunConfig())
    torch.cuda.synchronize()
    launches = {k: _llm_counts()[k] - before[k] for k in TRAIN_KERNELS}
    want = expected_launches(small, 1, 0)
    check(all(launches[k] == want[k] for k in TRAIN_KERNELS),
          f"parity step launched {launches}, expected {want}")
    t0 = time.perf_counter()
    loss_cpu, g_cpu = _loss_and_grads(small, cpu_params, toks, labels,
                                      RunConfig())
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
    check(loss_err <= TRAIN_LOSS_TOL,
          f"train parity: loss card {loss_card} vs CPU {loss_cpu}, "
          f"relative err {loss_err:.3g} over {TRAIN_LOSS_TOL}")
    errs = {}
    for key, g in g_cpu.items():
        errs[key] = float((g_card[key].cpu() - g).abs().max()
                          / g.abs().max())
        check(errs[key] <= TRAIN_GRAD_TOL,
              f"train parity: grad {key} card vs CPU {errs[key]:.3g} of "
              f"its max |g|, over {TRAIN_GRAD_TOL}")
    worst = max(errs, key=errs.get)
    log(f"[train parity] TinyLlama d {small.d_model}, "
        f"{small.num_layers} layers, B={TRAIN_PARITY['batch']} "
        f"S={TRAIN_PARITY['seq']}, weights normal(0, {LLM_PARITY_STD}): "
        f"loss card {loss_card:.7f} CPU {loss_cpu:.7f} (relative err "
        f"{loss_err:.3g}, tol {TRAIN_LOSS_TOL}); grads max err / leaf max "
        f"|g| {errs[worst]:.3g} at {worst} (tol {TRAIN_GRAD_TOL}); "
        f"launches {launches}; CPU step {cpu_s:.1f} s")
    return dict(loss_card=loss_card, loss_cpu=loss_cpu,
                loss_rel_err=loss_err, grad_rel_err=errs,
                launches=launches, cpu_seconds=cpu_s)


def _ocfg():
    from repro_torch.training import optimizer as opt
    # the launcher's schedule for this many steps
    return opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=max(TRAIN_STEPS // 10,
                                                          1),
                           total_steps=TRAIN_STEPS)


def _fresh_params(cfg):
    import torch
    from repro_torch.models import api
    return api.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                          "cuda")


def _split_step(cfg, run, params, state, launches):
    """One more step, split into forward, backward and AdamW (host
    clock, a sync at each boundary), with device memory at each: GiB
    allocated after it and the peak inside it.  Checks ``launches``."""
    import torch
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train
    _zero_llm_counts()
    toks, labels = (torch.as_tensor(a, device="cuda")
                    for a in next(_train_data(cfg, TRAIN_B, TRAIN_S)))
    for p in opt.leaves(train.trainable(params)):
        p.grad = None
    out, gib = {}, 2.0 ** 30
    torch.cuda.synchronize()
    out["start_gib"] = torch.cuda.memory_allocated() / gib

    def part(name, fn):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / gib
        out[f"{name}_end_gib"] = torch.cuda.memory_allocated() / gib
        return res
    loss, _ = part("forward", lambda: train.make_loss_fn(cfg, run)(
        params, toks, labels))
    part("backward", loss.backward)
    del loss
    part("adamw", lambda: opt.apply_updates(
        _ocfg(), params, opt.tree_map(lambda p: p.grad, params), state))
    got = {k: _llm_counts()[k] for k in TRAIN_KERNELS}
    check(got == launches, f"split step launched {got}, expected "
          f"{launches}")
    out["launches"] = got
    log(f"[train] one step, remat={run.remat!r}, split: " + ", ".join(
        f"{n} {out[n + '_ms']:.1f} ms (peak {out[n + '_peak_gib']:.2f} "
        f"GiB, then {out[n + '_end_gib']:.2f})"
        for n in ("forward", "backward", "adamw"))
        + f"; {out['start_gib']:.2f} GiB allocated before it")
    return out


def train_bounds(cfg, params):
    """The least time a train step could take on the card, from the
    step's work at B=TRAIN_B, S=TRAIN_S: (f32 operations, ms at
    F32_OPS_PER_S), and AdamW's (bytes, ms at HBM_BYTES_PER_S).  The
    products: 6 operations per matmul weight (every leaf of rank >= 2
    but the token embedding, which is gathered) and token.  Attention
    per layer and unmasked (q, k) pair of the causal S x S scores: the
    forward's 4 D (q.k and p.v) and the backward's 8 D (dv, dp, dq and
    dk), the function's work, not the plain backward's recompute over
    the full S x S.  AdamW reads p, g, m, v and writes p, m, v once."""
    n_mm = sum(p.numel() for k, p in _leaf_items(params)
               if p.dim() >= 2 and k != "embed/tok")
    n_all = sum(p.numel() for _, p in _leaf_items(params))
    tokens, S = TRAIN_B * TRAIN_S, TRAIN_S
    H, D = cfg.num_heads, cfg.resolved_head_dim
    attn = cfg.num_layers * TRAIN_B * H * D * 12 * (S * (S + 1) // 2)
    ops = 6 * n_mm * tokens + attn
    adamw_bytes = 7 * 4 * n_all
    return dict(step_ops=ops, step_bound_ms=ops / F32_OPS_PER_S * 1e3,
                adamw_bytes=adamw_bytes,
                adamw_bound_ms=adamw_bytes / HBM_BYTES_PER_S * 1e3)


def train_full(cfg, seen):
    """All layers of ``cfg`` at B=TRAIN_B, S=TRAIN_S on synthetic data
    (seed 0), from the launcher's init (seed 0): TRAIN_STEPS steps of
    ``train_loop`` (timed between steps, each ending in the loop's host
    read of its metrics), the detach witness after step 1 (every leaf's
    .grad finite and non-zero), exact launches, peak memory; one more
    step split into forward, backward and AdamW; then TRAIN_REMAT_STEPS
    steps with remat="block" from the same params and data: the same
    step-1 loss, grads within TRAIN_REMAT_TOL, the recompute's launches
    counted, kernel calls recorded by shape in ``seen``."""
    import torch
    from repro_torch.config import RunConfig
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train
    tokens = TRAIN_B * TRAIN_S
    L = cfg.num_layers
    per_fwd = expected_launches(cfg, 1, 0)
    marks, step1 = [], {}

    def callback(entry):
        t = time.perf_counter()
        check(math.isfinite(entry["loss"]), f"train step {entry['step']}: "
              f"loss {entry['loss']}")
        if entry["step"] == 0:
            for key, p in _leaf_items(params):
                g = p.grad
                check(g is not None, f"{key}: grad None after step 1")
                check(bool(torch.isfinite(g).all())
                      and float(g.abs().max()) > 0,
                      f"{key}: grad not finite or all zero after step 1")
            step1.update({k: p.grad.cpu() for k, p in _leaf_items(params)})
        marks.append((t, time.perf_counter()))

    params = _fresh_params(cfg)
    bounds = train_bounds(cfg, params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_llm_counts()
    t0 = time.perf_counter()
    params, state, hist = train.train_loop(
        cfg, RunConfig(), _train_data(cfg, TRAIN_B, TRAIN_S),
        steps=TRAIN_STEPS, ocfg=_ocfg(), params=params, device="cuda",
        log_every=1, callback=callback)
    counts = _llm_counts()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: counts[k] for k in TRAIN_KERNELS}
    want = {k: per_fwd[k] * TRAIN_STEPS for k in TRAIN_KERNELS}
    check(launches == want and counts["decode_attention"] == 0
          and counts["ssd_scan"] == 0,
          f"{TRAIN_STEPS} train steps launched {counts}, expected {want}")
    starts = [t0] + [end for _, end in marks[:-1]]
    step_s = [t - s for (t, _), s in zip(marks, starts)]
    med = sorted(step_s[1:])[len(step_s[1:]) // 2]
    log(f"[train] {cfg.name} {L} layers, B={TRAIN_B} S={TRAIN_S}, "
        f"lr {TRAIN_LR}: losses "
        + ", ".join(f"{h['loss']:.4f}" for h in hist)
        + f"; step s " + ", ".join(f"{x:.4f}" for x in step_s)
        + f"; median of steps 2-{TRAIN_STEPS} {med * 1e3:.1f} ms = "
        f"{tokens / med:.0f} tokens/s ({bounds['step_ops'] / med / 1e12:.1f}"
        f" TFLOP/s; bound {bounds['step_bound_ms']:.1f} ms, "
        f"{bounds['step_ops']:.4g} f32 operations at 67 TFLOP/s); peak "
        f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    split = _split_step(cfg, RunConfig(), params, state, {
        k: per_fwd[k] for k in TRAIN_KERNELS})
    log(f"[train] AdamW bound {bounds['adamw_bound_ms']:.2f} ms "
        f"({bounds['adamw_bytes'] / 1e9:.2f} GB at 3.35 TB/s) against "
        f"{split['adamw_ms']:.1f} ms")
    del params, state
    torch.cuda.empty_cache()
    # remat="block": the same first step, the recompute counted
    remat = RunConfig(remat="block")
    params = _fresh_params(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_step1 = {}

    def remat_cb(entry):
        if entry["step"] == 0:
            remat_step1.update({k: p.grad.cpu()
                                for k, p in _leaf_items(params)})
    _zero_llm_counts()
    t0 = time.perf_counter()
    with _recording(seen):
        params, state, rhist = train.train_loop(
            cfg, remat, _train_data(cfg, TRAIN_B, TRAIN_S),
            steps=TRAIN_REMAT_STEPS, ocfg=_ocfg(), params=params,
            device="cuda", log_every=1, callback=remat_cb)
    remat_s = time.perf_counter() - t0
    remat_peak = torch.cuda.max_memory_allocated()
    rcounts = {k: _llm_counts()[k] for k in TRAIN_KERNELS}
    recompute = {"rmsnorm": 2 * L, "flash_attention": L}
    want = {k: (per_fwd[k] + recompute[k]) * TRAIN_REMAT_STEPS
            for k in TRAIN_KERNELS}
    check(rcounts == want, f"remat steps launched {rcounts}, expected "
          f"{want}")
    check(rhist[0]["loss"] == hist[0]["loss"],
          f"remat step-1 loss {rhist[0]['loss']} != {hist[0]['loss']}")
    remat_err = {k: float((remat_step1[k] - g).abs().max() / g.abs().max())
                 for k, g in step1.items()}
    worst = max(remat_err, key=remat_err.get)
    check(remat_err[worst] <= TRAIN_REMAT_TOL,
          f"remat grads: {worst} {remat_err[worst]:.3g} of its max |g|, "
          f"over {TRAIN_REMAT_TOL}")
    log(f"[train remat] remat=block, {TRAIN_REMAT_STEPS} steps in "
        f"{remat_s:.2f} s: step-1 loss {rhist[0]['loss']:.6f} (equal); "
        f"grads max err / leaf max |g| {remat_err[worst]:.3g}; launches "
        f"{rcounts} (of which recompute "
        f"{ {k: v * TRAIN_REMAT_STEPS for k, v in recompute.items()} }); "
        f"peak memory {remat_peak / 2**30:.2f} GiB")
    remat_split = _split_step(cfg, remat, params, state, {
        k: per_fwd[k] + recompute[k] for k in TRAIN_KERNELS})
    del params, state
    torch.cuda.empty_cache()
    return dict(
        losses=[h["loss"] for h in hist], step_seconds=step_s,
        median_step_ms=med * 1e3, tokens_per_s=tokens / med, **bounds,
        peak_memory_bytes=peak, split=split, launches=launches,
        remat=dict(losses=[h["loss"] for h in rhist], seconds=remat_s,
                   grad_rel_err=remat_err, peak_memory_bytes=remat_peak,
                   launches=rcounts, split=remat_split,
                   recompute_launches={k: v * TRAIN_REMAT_STEPS
                                       for k, v in recompute.items()}))


def train_kernels(seen):
    """Each Function at every shape the training runs gave it: forward
    within TOL of the plain version, every input's gradient ``==``
    autograd through the plain version (which is its backward)."""
    import torch
    ops, plain = _llm_ops(), _plain_llm()
    err = collections.defaultdict(dict)
    shapes = collections.defaultdict(list)
    for (name, sig), _calls in sorted(seen.items()):
        check(name in TRAIN_KERNELS, f"training path called {name}")
        if sig in shapes[name]:
            continue
        shapes[name].append(sig)
        gen = torch.Generator(device="cuda").manual_seed(len(shapes[name]))

        def randn(shape):
            return torch.randn(shape, generator=gen, device="cuda")
        if name == "rmsnorm":
            x = randn(sig[0][0])
            ins = (x, randn(x.shape[-1:]) + 1)
        else:
            ins = tuple(randn(s) for s, _ in sig)
        dout = randn(sig[0][0])
        outs = {}
        for how, fn in (("kernel", getattr(ops[name], name)),
                        ("plain", plain[name])):
            leaves = [t.clone().requires_grad_() for t in ins]
            before = ops[name].launches
            y = fn(*leaves)
            y.backward(dout)
            torch.cuda.synchronize()
            check(ops[name].launches - before == (how == "kernel"),
                  f"{name} under grad ({how}) launched "
                  f"{ops[name].launches - before}")
            outs[how] = (y.detach(), [t.grad for t in leaves])
        _check_close(f"{name} under grad {sig}", outs["kernel"][0],
                     outs["plain"][0], "float32", err[name])
        for i, (g, w) in enumerate(zip(outs["kernel"][1],
                                       outs["plain"][1])):
            check(torch.equal(g, w), f"{name} {sig}: grad of input {i} "
                  f"differs from plain autograd by "
                  f"{float((g - w).abs().max()):.3g}")
    max_err = {n: e["float32"] for n, e in err.items()}
    check(set(max_err) == set(TRAIN_KERNELS), f"training path called "
          f"{sorted(max_err)}, expected {TRAIN_KERNELS}")
    log(f"[train kernels] forward under grad within {TOL['float32']} "
        f"(max abs err {max_err}), grads == plain autograd, at " + "; ".join(
            f"{n}: {[tuple(s for s, _ in sig) for sig in v]}"
            for n, v in shapes.items()))
    return dict(max_abs_err=max_err,
                shapes={n: [[list(s) for s, _ in sig] for sig in v]
                        for n, v in shapes.items()})


def train_launcher(cfg):
    """``python -m repro_torch.launch.train`` at full width, 3 steps,
    B=2, S=128, with a checkpoint under build/ (gitignored), restored
    with the port's ``checkpoint.restore``: step 3, every leaf finite,
    the moments non-zero.  The file is removed after."""
    import numpy as np
    from repro_torch.models import api
    from repro_torch.models.params import map_schema
    from repro_torch.training import checkpoint
    path = ROOT / "build" / "train_launcher_ckpt.npz"
    path.parent.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--steps", "3",
           "--seq-len", "128", "--batch", "2", "--log-every", "1",
           "--ckpt", str(path)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env=dict(
                              os.environ, PYTHONPATH=str(ROOT / "src")))
    run_s = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        log(f"[train launcher] | {line}")
    check(proc.returncode == 0, f"launcher exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    try:
        t0 = time.perf_counter()
        shape_of = map_schema(lambda p, _: np.broadcast_to(np.float32(0),
                                                            p.shape),
                              api.get_model(cfg).schema(cfg))
        back = checkpoint.restore(str(path), {
            "params": shape_of, "opt": {"step": np.int32(0), "m": shape_of,
                                        "v": shape_of}})
        restore_s = time.perf_counter() - t0
        size = path.stat().st_size
    finally:
        path.unlink(missing_ok=True)
    check(int(back["opt"]["step"]) == 3, f"checkpoint step "
          f"{back['opt']['step']}")
    for key, a in _leaf_items(back):
        check(bool(np.isfinite(a).all()), f"checkpoint {key} not finite")
    check(all(np.abs(a).max() > 0 for _, a in _leaf_items(back["opt"]["m"])),
          "checkpoint: a first moment is all zero")
    log(f"[train launcher] {' '.join(cmd[1:])}: {run_s:.1f} s; checkpoint "
        f"{size / 2**30:.2f} GiB restored with checkpoint.restore in "
        f"{restore_s:.1f} s (step 3, every leaf finite)")
    return dict(seconds=run_s, restore_seconds=restore_s,
                checkpoint_bytes=size, stdout=proc.stdout.splitlines())


def phase_train(card):
    """Full-width TinyLlama-1.1B training on the card (see the module
    docstring, phase 11).  Returns {kernel: launches on the phase's
    training paths} and the phase's details."""
    import torch
    from repro_torch.configs.tinyllama_1_1b import CONFIG
    t0 = time.perf_counter()
    seen = collections.Counter()
    parity = train_parity(CONFIG, seen)
    torch.cuda.empty_cache()
    full = train_full(CONFIG, seen)
    kernels = train_kernels(seen)
    launcher = train_launcher(CONFIG)
    launches = {k: parity["launches"][k] + full["launches"][k]
                + full["split"]["launches"][k]
                + full["remat"]["launches"][k]
                + full["remat"]["split"]["launches"][k]
                for k in TRAIN_KERNELS}
    secs = time.perf_counter() - t0
    log(f"[train] phase train {secs:.1f} s on {card}; launches on its "
        f"paths {launches}")
    return launches, dict(parity=parity, full=full, kernels=kernels,
                          launcher=launcher, launches=launches,
                          seconds=secs)


PLAN_TOL = 1e-9            # mean FID, the planner engines' contract
PLAN_SIZES = (1024, 10_000)  # single-scenario T* searches
PLAN_MANY = dict(S=1000, K=20)
REPLAN_MANY = dict(S=256, K=20)
PLAN_OPTIMAL_K = 8


def _ms(fn):
    """Host milliseconds of one planner call (each ends in a host read,
    so the device is done when it returns) and its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _plan_fid(quality, plan, ids):
    return quality.mean_fid([plan.steps_completed[k] for k in ids])


def _plan_services(taus):
    from repro_torch.core.service import ServiceRequest
    return ([ServiceRequest(id=i, deadline=float(t), spectral_eff=7.0)
             for i, t in enumerate(taus)],
            {i: float(t) for i, t in enumerate(taus)})


def plan_search(D, Q, K):
    """stacking(engine="torch") against vec on make_scenario(K, seed=0)
    with tau' = deadline - 0.4 (the reference benchmark's instance)."""
    from repro_torch.core.service import make_scenario
    from repro_torch.core.stacking import stacking
    from repro_torch.core.torchplan import kernels as pk
    scn = make_scenario(K=K, seed=0)
    tp = {s.id: s.deadline - 0.4 for s in scn.services}
    ids = [s.id for s in scn.services]
    vec_ms, pv = _ms(lambda: stacking(scn.services, tp, D, Q,
                                      engine="vec"))
    r0 = pk.READS["count"]
    first_ms, pt = _ms(lambda: stacking(scn.services, tp, D, Q,
                                        engine="torch"))
    reads = pk.READS["count"] - r0
    warm = [_ms(lambda: stacking(scn.services, tp, D, Q,
                                 engine="torch"))[0]
            for _ in range(3 if K <= 1024 else 1)]
    err = abs(_plan_fid(Q, pv, ids) - _plan_fid(Q, pt, ids))
    check(err < PLAN_TOL, f"stacking K={K}: torch vs vec mean FID "
          f"differs by {err:.3g}")
    pt.validate(gen_deadlines=tp)
    L = max(D.max_steps(v) for v in tp.values())
    log(f"[plan] stacking K={K} (L={L} levels): torch first call "
        f"{first_ms:.2f} ms, warm {min(warm):.2f} ms (best of "
        f"{len(warm)}), vec {vec_ms:.2f} ms on this host, {reads} "
        f"device-to-host reads a call, |dFID| {err:.3g}, plan valid")
    return dict(K=K, levels=L, first_ms=first_ms, warm_ms=min(warm),
                warm_all_ms=warm, vec_ms=vec_ms, reads=reads,
                fid_err=err, fid=_plan_fid(Q, pt, ids))


def plan_variants(D, K):
    """The clustered sweep of the K-service search under the design
    choices left open by the reference: the selection (full sort vs
    the radix passes), rounds between loop checks, and 4-level chunks
    each with a loop of its own (the reference's ``_LEVEL_CHUNK``).
    Every variant must give the same counts; the readings are host ms of
    the sweep alone (best of 3) with the reads it made."""
    import numpy as np
    import torch
    from repro_torch.core import arrays
    from repro_torch.core.service import make_scenario
    from repro_torch.core.torchplan import kernels as pk
    scn = make_scenario(K=K, seed=0)
    tp = {s.id: s.deadline - 0.4 for s in scn.services}
    arr = arrays.ServiceArrays.build([s.id for s in scn.services], tp)
    levels = np.arange(1, max(D.max_steps(v) for v in tp.values()) + 1)

    def sweep():
        Tc, t = pk.clustered_sweep(arr.tau_prime, arr.offsets, levels, D,
                                   ids=arr.ids)
        return pk._host(Tc)

    def chunked():
        # the same padded inputs as clustered_sweep, 4 level rows a loop
        Kp, Lp = pk._bucket(arr.K), pk._bucket(levels.size)
        taup = pk._pad_tail(arr.tau_prime, Kp, 0.0)
        off = pk._pad_tail(arr.offsets, Kp, 0)
        lv = pk._pad_tail(levels, Lp, int(levels[-1]))
        ids = pk._pad_tail(arr.ids, Kp, int(arr.ids.max()) + 1)
        shift = Kp.bit_length()
        step = D.a + D.b
        f_thr = pk._f_threshold(taup, off, lv, shift, step)
        kb = pk._key_bits(taup, off, shift, step)
        tp_t, off_t, lv_t, tie_t, f_t = pk._on(
            "cuda", taup[None], off[None], lv, pk._tie_ranks(taup, ids)[None],
            f_thr[None])
        Tc = torch.cat([pk._clustered_core(tp_t, off_t, lv_t[c:c + 4], tie_t,
                                           f_t[:, c:c + 4], shift, D.a, D.b,
                                           kb)[0][0]
                        for c in range(0, Lp, 4)])
        return pk._host(Tc[:levels.size, :arr.K])

    path = (pk._select, pk.ROUNDS_PER_CHECK)
    variants = {"path": (sweep, path[0], path[1])}
    variants["sort, check every round"] = (sweep, pk._sort_kth_key, 1)
    for r in (4, 16):
        variants[f"sort, {r} rounds a check"] = (sweep, pk._sort_kth_key, r)
        variants[f"radix, {r} rounds a check"] = (sweep, pk._select_kth_key,
                                                  r)
    variants["path selection, 4-level chunks"] = (chunked, path[0], path[1])
    rows, want = {}, None
    try:
        for name, (fn, select, rounds) in variants.items():
            pk._select, pk.ROUNDS_PER_CHECK = select, rounds
            fn()                                          # warm
            r0 = pk.READS["count"]
            times, got = [], None
            for _ in range(3):
                ms, got = _ms(fn)
                times.append(ms)
            reads = (pk.READS["count"] - r0) // 3
            if want is None:
                want = got
            check(np.array_equal(got, want), f"sweep variant {name!r}: "
                  f"counts differ from the path's")
            rows[name] = dict(ms=min(times), reads=reads)
            log(f"[plan] sweep K={K} {name}: {min(times):.2f} ms, {reads} "
                f"reads (counts equal)")
    finally:
        pk._select, pk.ROUNDS_PER_CHECK = path
    return rows


def plan_many_check(D, Q):
    """plan_many at S=1000, K=20 on default_rng(2).uniform(7, 20), every
    10th scenario held to the port's vec stacking."""
    import numpy as np
    from repro_torch.core.stacking import stacking
    from repro_torch.core.torchplan import kernels as pk
    from repro_torch.core.torchplan import plan_many
    S, K = PLAN_MANY["S"], PLAN_MANY["K"]
    taus = np.random.default_rng(2).uniform(7, 20, size=(S, K))
    r0 = pk.READS["count"]
    first_ms, res = _ms(lambda: plan_many(taus, delay=D, quality=Q))
    reads = pk.READS["count"] - r0
    warm = [_ms(lambda: plan_many(taus, delay=D, quality=Q))[0]
            for _ in range(3)]
    errs, vec_ms = [], 0.0
    for s in range(0, S, 10):
        svcs, tp = _plan_services(taus[s])
        ms, pv = _ms(lambda: stacking(svcs, tp, D, Q, engine="vec"))
        vec_ms += ms
        errs.append(abs(_plan_fid(Q, pv, range(K)) - res.mean_fid[s]))
    check(max(errs) < PLAN_TOL, f"plan_many: scenario off vec by "
          f"{max(errs):.3g}")
    log(f"[plan] plan_many S={S} K={K}: first call {first_ms:.2f} ms, warm "
        f"{min(warm):.2f} ms ({min(warm) / S * 1e3:.2f} us a scenario), "
        f"{reads} reads a call; vec stacking over the {len(errs)} sampled "
        f"scenarios {vec_ms:.2f} ms ({vec_ms / len(errs):.3f} ms a "
        f"scenario); max |dFID| {max(errs):.3g}")
    return dict(S=S, K=K, first_ms=first_ms, warm_ms=min(warm),
                us_per_scenario=min(warm) / S * 1e3, reads=reads,
                vec_sampled_ms=vec_ms, vec_sampled=len(errs),
                fid_err=max(errs))


def replan_many_check(D, Q):
    """replan_many at S=256, K=20 with random offsets and doomed services
    (offset > 0, tau' < 0), each scenario held to the vec residual
    replan of core/online.py: stacking over the residual budgets scored
    by _OffsetQuality."""
    import numpy as np
    from repro_torch.core.online import _OffsetQuality
    from repro_torch.core.stacking import stacking
    from repro_torch.core.torchplan import kernels as pk
    from repro_torch.core.torchplan import replan_many
    S, K = REPLAN_MANY["S"], REPLAN_MANY["K"]
    rng = np.random.default_rng(3)
    taus = rng.uniform(-1.0, 12.0, size=(S, K))
    offs = rng.integers(0, 9, size=(S, K))
    doomed = (offs > 0) & (taus < 0)
    r0 = pk.READS["count"]
    first_ms, res = _ms(lambda: replan_many(taus, delay=D, quality=Q,
                                            offsets=offs, doomed=doomed))
    reads = pk.READS["count"] - r0
    warm = [_ms(lambda: replan_many(taus, delay=D, quality=Q, offsets=offs,
                                    doomed=doomed))[0] for _ in range(3)]
    errs, vec_ms = [], 0.0
    for s in range(S):
        svcs, tp = _plan_services(taus[s])
        oq = _OffsetQuality(Q, offs[s].tolist())
        oq.refresh_doomed(svcs, tp)
        ms, pv = _ms(lambda: stacking(svcs, tp, D, oq, engine="vec"))
        vec_ms += ms
        errs.append(abs(_plan_fid(oq, pv, range(K)) - res.mean_fid[s]))
    check(max(errs) < PLAN_TOL, f"replan_many: scenario off the vec "
          f"residual replan by {max(errs):.3g}")
    log(f"[plan] replan_many S={S} K={K} ({int(doomed.sum())} doomed): "
        f"first call {first_ms:.2f} ms, warm {min(warm):.2f} ms, {reads} "
        f"reads a call; vec residual replans {vec_ms:.2f} ms; max |dFID| "
        f"{max(errs):.3g}")
    return dict(S=S, K=K, first_ms=first_ms, warm_ms=min(warm), reads=reads,
                vec_ms=vec_ms, doomed=int(doomed.sum()), fid_err=max(errs))


def optimal_check(D, Q):
    """optimal_plan(engine="torch") at K=8 against the scalar DP: each
    timed at its first call and warm (best of 3)."""
    import numpy as np
    from repro_torch.core.optimal import optimal_plan
    from repro_torch.core.torchplan import kernels as pk
    K = PLAN_OPTIMAL_K
    svcs, tp = _plan_services(np.random.default_rng(3).uniform(0.3, 4.0, K))
    scalar_first, ps = _ms(lambda: optimal_plan(svcs, tp, D, Q,
                                                engine="scalar"))
    scalar_ms = min(_ms(lambda: optimal_plan(svcs, tp, D, Q,
                                             engine="scalar"))[0]
                    for _ in range(3))
    r0 = pk.READS["count"]
    torch_first, pt = _ms(lambda: optimal_plan(svcs, tp, D, Q,
                                               engine="torch"))
    reads = pk.READS["count"] - r0
    torch_ms = min(_ms(lambda: optimal_plan(svcs, tp, D, Q,
                                            engine="torch"))[0]
                   for _ in range(3))
    err = abs(_plan_fid(Q, ps, range(K)) - _plan_fid(Q, pt, range(K)))
    check(err < PLAN_TOL, f"optimal_plan K={K}: torch vs scalar DP mean "
          f"FID differs by {err:.3g}")
    pt.validate(gen_deadlines=tp)
    log(f"[plan] optimal_plan K={K}: torch BFS warm {torch_ms:.2f} ms "
        f"(first {torch_first:.2f}, {reads} reads), scalar DP warm "
        f"{scalar_ms:.2f} ms (first {scalar_first:.2f}), |dFID| "
        f"{err:.3g}, plan valid")
    return dict(K=K, torch_ms=torch_ms, torch_first_ms=torch_first,
                scalar_ms=scalar_ms, scalar_first_ms=scalar_first,
                reads=reads, fid_err=err)


def closed_loop_check(D, Q):
    """Provisioner(make_scenario(K=8, seed=0), scheduler="stacking_offset",
    engine=...).run(execute="closed") on the simulated executor, planned
    with g x 0.5 so the loop replans: "torch" against "vec"."""
    from repro_torch.api import Provisioner
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.service import make_scenario
    out = {}
    for engine in ("vec", "torch"):
        ms, rep = _ms(lambda: Provisioner(
            make_scenario(K=8, seed=0), scheduler="stacking_offset",
            allocator="inv_se", delay=DelayModel(D.a * 0.5, D.b * 0.5),
            engine=engine, execute_kwargs=dict(
                executor="simulated", min_batches=2, drift_tol=0.2,
                executor_kwargs={"true_delay": D})).run(execute="closed"))
        out[engine] = (ms, rep)
    (vms, v), (tms, t) = out["vec"], out["torch"]
    errs = [abs(v.mean_fid - t.mean_fid),
            abs(v.execution.mean_fid - t.execution.mean_fid)]
    check(max(errs) < PLAN_TOL, f"closed loop: torch vs vec FID differs "
          f"by {max(errs):.3g}")
    check(t.execution.replans == v.execution.replans
          and t.execution.replans > 0,
          f"closed loop replans torch {t.execution.replans} vec "
          f"{v.execution.replans}")
    same = t.plan.batches == v.plan.batches and \
        t.execution.executed_log == v.execution.executed_log
    check(same, "closed loop: torch's plan or executed log differs from "
          "vec's")
    log(f"[plan] Provisioner stacking_offset closed loop K=8: replans "
        f"{t.execution.replans}, FID {t.execution.mean_fid:.6f} (torch) vs "
        f"{v.execution.mean_fid:.6f} (vec), plans and executed logs equal; "
        f"{tms:.1f} ms torch, {vms:.1f} ms vec")
    return dict(replans=t.execution.replans, fid=t.execution.mean_fid,
                fid_err=max(errs), same=same, torch_ms=tms, vec_ms=vms)


def phase_plan(card):
    """The planner's device engine on the card (see the module
    docstring, phase 12)."""
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.quality_model import PowerLawFID
    t0 = time.perf_counter()
    D, Q = DelayModel(), PowerLawFID()
    search = [plan_search(D, Q, K) for K in PLAN_SIZES]
    variants = plan_variants(D, PLAN_SIZES[-1])
    many = plan_many_check(D, Q)
    replan = replan_many_check(D, Q)
    optimal = optimal_check(D, Q)
    closed = closed_loop_check(D, Q)
    secs = time.perf_counter() - t0
    log(f"[done] phase plan {secs:.1f} s on {card}")
    return dict(search=search, variants=variants, plan_many=many,
                replan_many=replan, optimal=optimal, closed=closed,
                seconds=secs)


# ---------------------------------------------------------------------------
# Many edge servers: the fleet, the multi-server and the online facades
# ---------------------------------------------------------------------------

FLEET_TOL = 1e-9           # mean FID, the planner engines' contract
FLEET_COUNTS = ("arrivals", "admitted", "rejected", "completed", "replans",
                "peak_live_rows")
FLEET_REDUCED = dict(cells=128, services=100_000)   # benchmarks/fleet.py
# one-speed 10-cell fleets for event mode, (bandwidth Hz, Poisson rate):
# tests/test_fleet.py's TestEngineParity fleet, and one loaded lightly
# enough that most plans meet their deadlines
FLEET_EVENT_ONE_SPEED = ((2.0e6, 5.0), (8.0e6, 1.0))
FLEET_FULL = dict(cells=512, services=1_000_000)    # FLEET_FULL=1 sizes
PLACEMENT_K = dict(round_robin=12, least_loaded=12, greedy_fid=12,
                   alternating=6)   # alternating re-plans cells per move


def scale_fleet(cells, services):
    """``benchmarks/fleet.py:_scale``'s fleet: ``cells`` cells of 8 MHz,
    Poisson rate 2, the horizon sized 2.5% above ``services``, seed 0;
    epochs of horizon / 64."""
    from repro_torch.core.fleet import FleetCell, FleetScenario
    from repro_torch.core.traffic import PoissonProcess
    rate = 2.0
    horizon = 1.025 * services / (cells * rate)
    return FleetScenario(
        cells=tuple(FleetCell(bandwidth_hz=8.0e6,
                              process=PoissonProcess(rate))
                    for _ in range(cells)), horizon=horizon, seed=0)


def _fleet_run(fleet, engine, **kw):
    """One ``simulate_fleet`` run, its host seconds (synchronised before
    and after), device-to-host reads and the peak device memory above
    what was allocated before it."""
    import torch
    from repro_torch.core.fleet import simulate_fleet
    from repro_torch.core.torchplan import kernels as pk
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    r0 = pk.READS["count"]
    t0 = time.perf_counter()
    res = simulate_fleet(fleet, engine=engine, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    row = dict(dataclasses.asdict(res), seconds=secs,
               services_per_s=res.arrivals / secs,
               reads=pk.READS["count"] - r0,
               peak_bytes=torch.cuda.max_memory_allocated() - base)
    check(res.admitted + res.rejected == res.arrivals
          and res.completed == res.admitted,
          f"fleet {engine}: arrivals not accounted for: {res}")
    return res, row


def _fleet_line(tag, row):
    log(f"[fleet] {tag} {row['engine']}: {row['arrivals']} arrivals, "
        f"{row['seconds']:.2f} s, {row['services_per_s']:.0f} services/s, "
        f"planner_calls {row['planner_calls']} (replans "
        f"{row['replans']}), {row['reads']} reads, peak_live_rows "
        f"{row['peak_live_rows']}, mean FID {row['mean_fid']:.9f}, outage "
        f"{row['outage_rate']:.4f}, peak device memory "
        f"{row['peak_bytes'] / 2**20:.1f} MiB")


def fleet_scale_check():
    """Epoch mode at the reference's reduced scale on torch and vec (the
    same accounting, mean FID within 1e-9, 64 planner calls against
    8192), then the paper scale on torch alone."""
    fleet = scale_fleet(**FLEET_REDUCED)
    kw = dict(allocator="inv_se", mode="epoch", epoch=fleet.horizon / 64.0)
    out = {}
    for engine in ("torch", "vec"):
        res, out[engine] = _fleet_run(fleet, engine, **kw)
        _fleet_line(f"epoch x{fleet.n_cells}", out[engine])
    t, v = out["torch"], out["vec"]
    err = abs(t["mean_fid"] - v["mean_fid"])
    check(err < FLEET_TOL, f"fleet epoch: torch vs vec mean FID differs by "
          f"{err:.3g}")
    check(all(t[k] == v[k] for k in FLEET_COUNTS),
          f"fleet epoch: counts differ: " + ", ".join(
              f"{k} {t[k]}/{v[k]}" for k in FLEET_COUNTS))
    check(t["planner_calls"] == 64 and v["planner_calls"] == v["replans"],
          f"fleet epoch: planner calls torch {t['planner_calls']}, vec "
          f"{v['planner_calls']}")
    log(f"[fleet] epoch x{fleet.n_cells}: |dFID| {err:.3g}, counts equal, "
        f"torch / vec wall {t['seconds'] / v['seconds']:.3f}")
    full = scale_fleet(**FLEET_FULL)
    res, out["full"] = _fleet_run(full, "torch", allocator="inv_se",
                                  mode="epoch", epoch=full.horizon / 64.0)
    check(res.arrivals >= FLEET_FULL["services"],
          f"fleet full: {res.arrivals} arrivals")
    _fleet_line(f"epoch x{full.n_cells} (paper scale)", out["full"])
    out["fid_err"] = err
    return out


def fleet_event_check():
    """Event mode on ``benchmarks/fleet.py:_equivalence``'s fleet (3 cells
    at speeds 1.0, 1.25, 1.5, seed 11) on torch against the object-graph
    simulator ``simulate_online_multi`` with the placement pinned, for
    each closed-form allocator; vec's planner calls beside torch's."""
    from repro_torch.core.bandwidth import equal_allocate, inv_se_allocate
    from repro_torch.core.fleet import (FleetCell, FleetScenario,
                                        fleet_to_scenario)
    from repro_torch.core.multiserver import simulate_online_multi
    from repro_torch.core.stacking import stacking
    from repro_torch.core.traffic import PoissonProcess
    fleet = FleetScenario(cells=[FleetCell(bandwidth_hz=1.2e6 * (c + 1),
                                           speed=1.0 + 0.25 * c,
                                           process=PoissonProcess(2.0))
                                 for c in range(3)], horizon=8.0, seed=11)
    scn, assignment = fleet_to_scenario(fleet)
    cell_of = {s.id: assignment[i] for i, s in enumerate(scn.services)}
    out = {}
    for name, core in (("equal", lambda s, *a, **k: equal_allocate(s)),
                       ("inv_se", lambda s, *a, **k: inv_se_allocate(s))):
        _, t = _fleet_run(fleet, "torch", allocator=name, mode="event")
        _, v = _fleet_run(fleet, "vec", allocator=name, mode="event")
        ref = simulate_online_multi(
            scn, stacking, core, placement=lambda svc, sim: cell_of[svc.id],
            engine="vec")
        err = abs(t["mean_fid"] - ref.mean_fid)
        check(err < FLEET_TOL and t["admitted"] == len(ref.outcomes),
              f"fleet event {name}: |dFID| {err:.3g} against "
              f"simulate_online_multi, admitted {t['admitted']} / "
              f"{len(ref.outcomes)}")
        log(f"[fleet] event x3 {name}: {t['arrivals']} arrivals, |dFID| "
            f"{err:.3g} against simulate_online_multi, admitted equal; "
            f"planner_calls torch {t['planner_calls']} vec "
            f"{v['planner_calls']}; {t['seconds']:.3f} s torch, "
            f"{v['seconds']:.3f} s vec")
        out[name] = dict(torch=t, vec=v, fid_err=err, K=len(scn.services))
    return out


def fleet_event_batched_check():
    """Event mode on one-speed 10-cell fleets (FLEET_EVENT_ONE_SPEED,
    horizon 30 s, seed 1, inv_se) on torch against vec: mean FID within
    1e-9, counts equal, and fewer torch planner calls than replans, so
    that rounds of several cells ran as one replan_many call."""
    from repro_torch.core.fleet import FleetCell, FleetScenario
    from repro_torch.core.traffic import PoissonProcess
    out = {}
    for bw, rate in FLEET_EVENT_ONE_SPEED:
        fleet = FleetScenario(cells=[FleetCell(bandwidth_hz=bw,
                                               process=PoissonProcess(rate))
                                     for _ in range(10)],
                              horizon=30.0, seed=1)
        _, t = _fleet_run(fleet, "torch", allocator="inv_se", mode="event")
        _, v = _fleet_run(fleet, "vec", allocator="inv_se", mode="event")
        tag = f"event x10 {bw / 1e6:g} MHz rate {rate:g}"
        err = abs(t["mean_fid"] - v["mean_fid"])
        check(err < FLEET_TOL, f"fleet {tag}: torch vs vec mean FID "
              f"differs by {err:.3g}")
        check(all(t[k] == v[k] for k in FLEET_COUNTS),
              f"fleet {tag}: counts differ: " + ", ".join(
                  f"{k} {t[k]}/{v[k]}" for k in FLEET_COUNTS))
        check(t["planner_calls"] < t["replans"]
              and v["planner_calls"] == v["replans"],
              f"fleet {tag}: planner calls torch {t['planner_calls']}, vec "
              f"{v['planner_calls']}, replans {t['replans']}")
        _fleet_line(tag, t)
        _fleet_line(tag, v)
        log(f"[fleet] {tag}: |dFID| {err:.3g}, counts equal, "
            f"{t['replans'] / t['planner_calls']:.2f} cells a torch call")
        out[f"{bw:g}/{rate:g}"] = dict(torch=t, vec=v, fid_err=err)
    return out


def multiserver_check():
    """``MultiServerProvisioner`` on make_scenario(K, n_servers=3,
    server_speed_range=(0.7, 1.3), seed=0): every static placement's
    run(), and run_online() under each online router on the same
    scenario with arrival_rate=2, on torch against vec: assignments
    equal, mean FID within 1e-9."""
    from repro_torch.api import MultiServerProvisioner
    from repro_torch.core import multiserver
    from repro_torch.core.service import make_scenario
    from repro_torch.core.torchplan import kernels as pk
    kw = dict(n_servers=3, server_speed_range=(0.7, 1.3), seed=0)
    cases = [(p, "run", dict(K=K, **kw), {}) for p, K in PLACEMENT_K.items()]
    cases += [(r, "run_online", dict(K=12, arrival_rate=2.0, **kw),
               dict(online_placement=getattr(multiserver, r)))
              for r in ("earliest_free", "best_projection")]
    out = {}
    for name, method, scn_kw, run_kw in cases:
        scn = make_scenario(**scn_kw)
        reps, row = {}, {}
        for engine in ("torch", "vec"):
            ms = MultiServerProvisioner(
                scn, placement=name if method == "run" else "least_loaded",
                allocator="inv_se", engine=engine)
            r0 = pk.READS["count"]
            row[f"{engine}_ms"], reps[engine] = _ms(
                lambda: getattr(ms, method)(**run_kw))
            row[f"{engine}_reads"] = pk.READS["count"] - r0
        t, v = reps["torch"], reps["vec"]
        same = (t.assignment == v.assignment if method == "run_online"
                else list(t.assignment) == list(v.assignment))
        err = abs(t.mean_fid - v.mean_fid)
        check(same and err < FLEET_TOL, f"multi-server {name} {method}: "
              f"assignments equal {same}, |dFID| {err:.3g}")
        row.update(K=scn.K, fid_err=err, mean_fid=t.mean_fid)
        out[f"{method} {name}"] = row
        log(f"[fleet] multi-server {method} {name} K={scn.K}: assignments "
            f"equal, |dFID| {err:.3g}; torch {row['torch_ms']:.1f} ms "
            f"({row['torch_reads']} reads), vec {row['vec_ms']:.1f} ms")
    return out


def fleet_execution_check(wl, g, card):
    """The facades on the full-width U-Net, planned with the card's
    calibrated g: OnlineProvisioner(execute=True) replays its committed
    batches, and a 2-cell speed-1 multi-server run executes each cell
    through execute_report(mode="open", exec_engine="bucketed").
    groupnorm_silu's launches are counted exactly (graph replays
    included) and returned."""
    import numpy as np
    import torch
    from repro_torch.api import (MultiServerProvisioner, OnlineProvisioner,
                                 execute_report)
    from repro_torch.core.service import make_scenario
    from repro_torch.diffusion import unet
    ex = wl._ex()
    cfg = ex.cfg
    calls = unet.gn_silu_calls(cfg)
    step = g.g(8)
    scn_kw = dict(tau_min=20.0 * step, tau_max=80.0 * step,
                  content_bits=512.0)
    scn = make_scenario(K=8, arrival_rate=1.0 / (10.0 * step), seed=0,
                        **scn_kw)
    d0 = ex.dispatches
    t0 = time.perf_counter()
    rep, acc = _gn_run(ex, calls, "online replay", lambda: OnlineProvisioner(
        scn, workload=wl, scheduler="stacking", allocator="inv_se",
        delay=g, engine="torch", device="cuda", execute=True,
        seed=0).run())
    wall = time.perf_counter() - t0
    batches = rep.result.executed_batches
    check(ex.dispatches - d0 == len(batches) == acc["eager_forwards"]
          and [x for x, _ in rep.timings] == [len(ids) for _, ids in batches],
          f"online replay: {ex.dispatches - d0} dispatches, {acc}, for "
          f"{len(batches)} simulated batches")
    ran = sorted(o.id for o in rep.result.outcomes if o.steps > 0)
    check(sorted(rep.content) == ran and ran
          and all(bool(np.isfinite(v).all()) for v in rep.content.values()),
          f"online replay: images of {sorted(rep.content)}, services with "
          f"steps {ran}, or not finite")
    measured = sum(s for _, s in rep.timings)
    predicted = sum(g.g(len(ids)) for _, ids in batches)
    log(f"[fleet] OnlineProvisioner(execute=True) K={scn.K}, arrivals every "
        f"~{10 * step * 1e3:.1f} ms: {len(batches)} batches replayed = "
        f"simulated, mean FID {rep.mean_fid:.4f}, outage "
        f"{rep.outage_rate:.1%}, reject {rep.reject_rate:.1%}; timed "
        f"batches {measured:.4f} s against g's {predicted:.4f} s "
        f"({measured / predicted:.4f}); groupnorm_silu {acc['executed']} = "
        f"{calls} x {acc['eager_forwards']}; whole run {wall:.3f} s on "
        f"{card}")
    online = dict(K=scn.K, batches=len(batches), mean_fid=rep.mean_fid,
                  outage_rate=rep.outage_rate, reject_rate=rep.reject_rate,
                  measured_s=measured, predicted_s=predicted, wall_s=wall,
                  accounting=acc)
    executed = acc["executed"]

    mscn = make_scenario(K=8, n_servers=2, seed=1, **scn_kw)
    multi = MultiServerProvisioner(mscn, allocator="inv_se", delay=g,
                                   engine="torch").run()
    cells = []
    for sid, cell in zip(multi.server_ids, multi.reports):
        check(cell.delay == g, f"cell {sid} plans with {cell.delay}, not g")
        res, acc = _gn_run(ex, calls, f"cell {sid}", lambda: execute_report(
            cell, wl, mode="open", exec_engine="bucketed",
            generator=torch.Generator().manual_seed(sid)))
        n = cell.plan.num_batches
        check(len(res.records) == n == acc["graph_forwards"]
              and acc["eager_forwards"] <= acc["captures"]
              and res.session_telemetry["dispatches"] == n,
              f"cell {sid}: {len(res.records)} records, {acc}, for {n} "
              f"planned batches")
        check(all(bool(np.isfinite(res.content[o.id]).all())
                  for o in res.outcomes), f"cell {sid}: image not finite")
        ratio = res.wall_clock / res.predicted_wall()
        executed += acc["executed"]
        log(f"[fleet] cell {sid} of 2 (speed 1, K={cell.scenario.K}): "
            f"execute_report(open, bucketed) {n} batches, delivered FID "
            f"{res.delivered_fid:.4f}, outage {res.outage_rate:.1%}, "
            f"wall_clock / predicted_wall() {ratio:.4f}; groupnorm_silu "
            f"{acc['executed']} = {calls} x "
            f"{acc['eager_forwards'] + acc['graph_forwards']}")
        cells.append(dict(server=sid, K=cell.scenario.K, batches=n,
                          delivered_fid=res.delivered_fid,
                          outage_rate=res.outage_rate,
                          wall_clock=res.wall_clock,
                          predicted_wall=res.predicted_wall(), ratio=ratio,
                          accounting=acc))
    torch.cuda.synchronize()
    return dict(online=online, cells=cells, launches=executed)


def phase_fleet(wl, g, card):
    """Many edge servers on the card (see the module docstring, phase
    6d).  Returns the phase's details, ``launches`` its groupnorm_silu
    launches."""
    t0 = time.perf_counter()
    execution = fleet_execution_check(wl, g, card)
    scale = fleet_scale_check()
    event = fleet_event_check()
    event_batched = fleet_event_batched_check()
    multi = multiserver_check()
    secs = time.perf_counter() - t0
    log(f"[done] phase fleet {secs:.1f} s on {card}")
    return dict(execution=execution, scale=scale, event=event,
                event_batched=event_batched, multi=multi,
                launches=execution["launches"], seconds=secs)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.ddim_cifar10 import CONFIG

    t_start = time.perf_counter()
    smi = phase_device()
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    phase_build()
    kernel, rows = phase_kernels(CONFIG)
    main_path, wl, (scn, g) = phase_main(CONFIG, card)
    trace = phase_trace(wl)
    parity = phase_parity(CONFIG, wl.params)
    t0 = time.perf_counter()
    g_bucketed, bucketed = phase_bucketed(wl, main_path, scn, g, card)
    bucketed["seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    closed = phase_closed(wl, scn, {"dict": g, "bucketed": g_bucketed},
                          card)
    closed["seconds"] = time.perf_counter() - t0
    log(f"[done] phase bucketed {bucketed['seconds']:.1f} s, phase closed "
        f"{closed['seconds']:.1f} s")
    fleet = phase_fleet(wl, g, card)
    # launches executed on the paths: main, the bucketed graphs (replays
    # counted), the closed loop and the facades of phase fleet
    kernel["launches"] = main_path["launches"] + bucketed["launches"] + \
        closed["launches"] + fleet["launches"]
    kernel["launches_by_path"] = dict(main=main_path["launches"],
                                      bucketed=bucketed["launches"],
                                      closed=closed["launches"],
                                      fleet=fleet["launches"])
    del wl
    from repro_torch.configs.tinyllama_1_1b import CONFIG as TINYLLAMA
    from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2
    per_model, llm = {}, {}
    for cfg in (TINYLLAMA, ZAMBA2):
        per_model[cfg.name], llm[cfg.name] = phase_llm(card, cfg)
    moe_models, moe = phase_moe(card)
    llm_kernels = merge_kernel_summaries({**per_model, **moe_models})
    train_launches, train = phase_train(card)
    plan = phase_plan(card)
    for entry in llm_kernels:
        name = entry["name"]
        entry["launches_by_path"] = {
            path: sum(k[name]["launches"] for k in models.values()
                      if name in k)
            for path, models in (("llm_decode", per_model),
                                 ("moe", moe_models))}
        if name in train_launches:
            entry["launches_by_path"]["train"] = train_launches[name]
            entry["launches"] += train_launches[name]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       train["kernels"]["max_abs_err"][name])
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        kernel=kernel, kernel_rows=rows, main=main_path, trace=trace,
        parity=parity, bucketed=bucketed, closed=closed, fleet=fleet,
        llm_kernels=llm_kernels, llm=llm, moe=moe, train=train, plan=plan,
        seconds=time.perf_counter() - t_start), indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [kernel] + llm_kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
