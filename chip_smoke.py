#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, no result line)
when it does not hold:

  1. device   -- needs torch.cuda.is_available(); prints the card's name
                 and power limit; turns TF32 off for cuDNN and matmul.
  2. build    -- builds every CUDA kernel of the path with nvcc (all
                 sources at once) and prints the build seconds.
  3. kernels  -- each kernel's wrapper against its plain PyTorch version
                 on the card, at every shape one full-width U-Net forward
                 gives it, B in {1, 8, 16}, float32 (tol 2e-5) and
                 bfloat16 (tol 2e-2); times at B=16: kernel, plain
                 version, library yardstick and the bound.
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
                 host time of one wrapper call.
  6. parity   -- a short plan (K=2) on the card (kernel) and on the CPU
                 (plain version), same params with conv_out redrawn and
                 same latents; final images agree within 1e-3 (max abs
                 error).

The last lines are the card (nvidia-smi), one JSON object with the
kernels' numbers and, last, {"ok": true, "device": {...}}.  Details go
to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12              # H100 SXM float32 outside tensor cores
GN_OPS_PER_ELEMENT = 12            # mean 1, variance 3, normalize 4, SiLU 4
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
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
    names = ["groupnorm_silu"]
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


def phase_kernels(cfg):
    import torch
    import torch.nn.functional as F
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
            if B != 16:
                continue
            xn = x32.permute(0, 3, 1, 2).contiguous()
            k_ms = device_time_ms(lambda: ops.groupnorm_silu(x32, s, b, G))
            p_ms = device_time_ms(lambda: groupnorm_silu_ref(x32, s, b, G))
            l_ms = device_time_ms(lambda: F.group_norm(xn, G, s, b, 1e-6))
            nbytes = 2 * x32.numel() * 4 + 2 * C * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = GN_OPS_PER_ELEMENT * x32.numel() / F32_OPS_PER_S * 1e3
            rows.append(dict(shape=[16, H, W, C], calls=n, ms=k_ms,
                             plain_ms=p_ms, group_norm_ms=l_ms,
                             bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations", bytes=nbytes))
    log(f"[kernels] all {len(shapes)} shapes x B in (1, 8, 16) match the "
        f"plain version: max abs err float32 {err['float32']:.3g} "
        f"(tol 2e-5), bfloat16 {err['bfloat16']:.3g} (tol 2e-2)")
    log("[kernels] B=16 float32, device time per call (CUDA graph, "
        "L2-warm); library = F.group_norm on an NCHW copy, GroupNorm only")
    log(f"[kernels] {'(B,H,W,C)':>18} {'calls':>5} {'kernel_us':>10} "
        f"{'plain_us':>9} {'library_us':>10} {'bound_us':>9} "
        f"{'bound/kern':>10}")
    for r in rows:
        log(f"[kernels] {str(tuple(r['shape'])):>18} {r['calls']:>5} "
            f"{r['ms'] * 1e3:>10.2f} {r['plain_ms'] * 1e3:>9.2f} "
            f"{r['group_norm_ms'] * 1e3:>10.2f} {r['bound_ms'] * 1e3:>9.2f} "
            f"{r['bound_ms'] / r['ms']:>10.3f}")

    def per_forward(key):
        return sum(r[key] * r["calls"] for r in rows)
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
                            f"forward at B=16, float32")
    log(f"[kernels] per forward at B=16: kernel {summary['ms']:.4f} ms, "
        f"plain {summary['plain_ms']:.4f} ms, F.group_norm "
        f"{summary['library_ms']:.4f} ms, bound {summary['bound_ms']:.4f} ms")
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
                provision_launches=main_launches, forwards=forwards), wl


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
    return dict(batch=batch, wall_us=wall_us, device_us=device_us,
                busy=busy, launches_per_step=launches, gn_us=gn_us,
                top=sorted(dev.items(), key=lambda kv: -kv[1])[:8],
                host_us_per_call=host)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_parity(cfg, params):
    import numpy as np
    import torch
    from repro_torch.api import DiffusionWorkload
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.plan import BatchPlan
    from repro_torch.diffusion import unet
    from repro_torch.kernels.groupnorm_silu import ops

    # conv_out is initialised at 1e-10 (eps ~ 0): redraw it so the
    # comparison means something.  Each executor moves the params to
    # its own device.
    params = dict(params)
    w = params["conv_out"]
    params["conv_out"] = torch.randn(
        w.shape, generator=torch.Generator().manual_seed(7)) \
        / math.sqrt(w.shape[1])
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
    main_path, wl = phase_main(CONFIG, card)
    kernel["launches"] = main_path["launches"]
    trace = phase_trace(wl)
    parity = phase_parity(CONFIG, wl.params)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda,
        kernel=kernel, kernel_rows=rows, main=main_path, trace=trace,
        parity=parity,
        seconds=time.perf_counter() - t_start), indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": [kernel]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
