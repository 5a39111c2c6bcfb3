"""Time the rmsnorm kernel of one or more checkouts on one card.

    python3 tools/time_rmsnorm.py [--other DIR ...]
                                  [--variant NAME:KEY=VALUE,...]
                                  [--batch 1,8,16] [--dtype float32,bfloat16]

At every rmsnorm call shape of the two LLM paths, (B, S, d) with d in
{2048 (TinyLlama), 2560, 5120 (Zamba2's d_model and gated d_inner)}, S
in {1 (decode), 128 (prefill)}, each B of ``--batch`` and each type of
``--dtype`` (x and scale alike): the wrapper's device time per call and
F.rms_norm's beside it, each twice:

- L2-warm: chip_smoke.device_time_ms, a CUDA graph of 20 calls on the
  same inputs replayed 10 times (the method of chip_smoke.py);
- L2-cold: one CUDA graph of calls that rotate over distinct x and
  scale, together more than 50 MB (the card's L2), replayed.

Each row also gives the bound (chip_smoke._bound: x read and y written
once, scale read once, against 4 operations an element at 67 TFLOP/s)
and the kernel's plan (ops.plan) where the checkout has one.  A
launch-floor row times a torch.add on 8 elements under the same warm
harness: the least any one-launch call takes.  The host time of one
wrapper call at (8, 1, 2048) f32 (the least of 5 runs of 200 calls, no
sync) is given beside a torch.add on the same x.  Sums over one
prefill and one decode step at B=8 (TinyLlama 45 calls a forward,
Zamba2 73 at d 2560 and 54 at 5120) close each run.  At B=8 each row
also records the launch configuration of the kernel and of F.rms_norm
(grid, block, registers, the profiler's estimate of achieved occupancy),
read from a torch.profiler trace.

With ``--other DIR`` (an unpacked checkout, e.g. the parent commit; may
be given more than once) each runs in a process of its own, in the
order others, this, this, others reversed; every checkout's kernel is
built first, all compilers at once, and each build's ptxas registers,
stack and spills are summed up.  ``--variant NAME:KEY=VALUE,...``
also times this checkout with constants of
``kernels/rmsnorm/ops.py`` replaced (e.g. ``nv3:NV_AIM=3``), in
the middle of the order; a run that fails is reported and the others go
on.  Prints a table of the runs' times and writes every row to
chiprun_out/time_rmsnorm.json.
"""

from __future__ import annotations

import argparse
import ast
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIDTHS = {2048: ("tinyllama-1.1b", 45), 2560: ("zamba2-2.7b", 73),
          5120: ("zamba2-2.7b", 54)}     # d -> (model, calls a forward)
SEQS = (1, 128)
COLD_BYTES = 64 * 2 ** 20                # distinct inputs a cold graph reads
COLD_CALLS = 8192                        # most calls one cold graph holds


def _graph_ms(fns, replays: int) -> float:
    """Device time per call of ``fns`` (each called once, in order),
    captured in one CUDA graph and replayed ``replays`` times."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns[:3]:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (len(fns) * replays)
    del graph
    return ms


def _cold_ms(call, shape, dt):
    """Device time per call of ``call(x, scale)`` rotating over distinct
    inputs of ``shape`` that total at least COLD_BYTES (at most
    COLD_CALLS of them), and the bytes they total."""
    import torch
    each = (math.prod(shape) + shape[-1]) * torch.tensor([], dtype=dt) \
        .element_size()
    n = max(2, min(COLD_CALLS, -(-COLD_BYTES // each)))
    xs = torch.randn((n,) + tuple(shape), device="cuda").to(dt)
    ss = torch.randn((n, shape[-1]), device="cuda").to(dt)
    fns = [lambda i=i: call(xs[i], ss[i]) for i in range(n)]
    ms = _graph_ms(fns, max(3, 400 // n))
    return ms, n * each


def _host_us(fn, calls: int = 200, runs: int = 5) -> float:
    import torch
    best = math.inf
    for _ in range(runs):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e6 / calls)
        torch.cuda.synchronize()
    return best


def launch_configs(fn) -> list:
    """Grid, block, registers, shared memory, the profiler's estimate of
    achieved occupancy and the duration of each kernel one ``fn()``
    launches, from torch.profiler's trace."""
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    keys = ("grid", "block", "registers per thread", "shared memory",
            "blocks per SM", "warps per SM", "est. achieved occupancy %")
    return [dict(name=e["name"][:80], us=e.get("dur"),
                 **{k: e["args"].get(k) for k in keys})
            for e in events if e.get("cat") == "kernel"]


def worker(settings: dict, batches: list, dtypes: list) -> dict:
    import dataclasses
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    from chip_smoke import RMS_OPS_PER_ELEMENT, _bound, device_time_ms
    from repro_torch.kernels.rmsnorm import ops
    for key, value in settings.items():
        if not hasattr(ops, key):
            raise SystemExit(f"ops has no constant {key}")
        setattr(ops, key, value)
    if settings:
        ops.plan.cache_clear()
    out = {"checkout": str(Path(ops.__file__).resolve().parents[4]),
           "settings": settings, "rows": []}
    gen = torch.Generator(device="cuda").manual_seed(31)
    for name in dtypes:
        dt = getattr(torch, name)
        for B in batches:
            for S in SEQS:
                for d, (model, calls) in WIDTHS.items():
                    x = torch.randn((B, S, d), generator=gen,
                                    device="cuda").to(dt)
                    w = torch.randn(d, generator=gen, device="cuda").to(dt)
                    nb = (2 * x.numel() + d) * x.element_size()
                    bound, by = _bound(nb, RMS_OPS_PER_ELEMENT * x.numel())

                    def lib(a, s, d=d):
                        return F.rms_norm(a, (d,), s, 1e-6)
                    kern_cold, cold_bytes = _cold_ms(ops.rmsnorm, x.shape,
                                                     dt)
                    row = dict(
                        shape=[B, S, d], types=name, model=model,
                        calls=calls, bound_ms=bound, bound_by=by, bytes=nb,
                        ms=device_time_ms(lambda: ops.rmsnorm(x, w)),
                        library_ms=device_time_ms(lambda: lib(x, w)),
                        cold_ms=kern_cold,
                        library_cold_ms=_cold_ms(lib, x.shape, dt)[0],
                        cold_bytes=cold_bytes)
                    if B == 8:
                        row["trace"] = dict(
                            kernel=launch_configs(lambda: ops.rmsnorm(x, w)),
                            library=launch_configs(lambda: lib(x, w)))
                    if hasattr(ops, "plan"):
                        row["plan"] = dataclasses.asdict(ops.plan(
                            d, x.element_size()))
                    out["rows"].append(row)
    tiny = torch.zeros(8, device="cuda")
    out["launch_floor_ms"] = device_time_ms(lambda: tiny + 1.0)
    x = torch.randn((8, 1, 2048), device="cuda")
    w = torch.ones(2048, device="cuda")
    out["host_us"] = {"rmsnorm wrapper": _host_us(lambda: ops.rmsnorm(x, w)),
                      "torch.add": _host_us(lambda: x + 1.0)}
    for B in batches:
        if "float32" not in dtypes:
            break
        mine = [r for r in out["rows"]
                if r["shape"][0] == B and r["types"] == "float32"]
        out[f"per_forward_B{B}"] = {
            model: {key: sum(r[key] * r["calls"] for r in mine
                             if r["model"] == model)
                    for key in ("ms", "cold_ms", "library_ms",
                                "library_cold_ms", "bound_ms")}
            for model in sorted({m for m, _ in WIDTHS.values()})}
    return out


def run(checkout: Path, settings: dict, batches: list, dtypes: list) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--batch", ",".join(map(str, batches)), "--dtype",
           ",".join(dtypes), "--settings", json.dumps(settings)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        return dict(checkout=str(checkout), settings=settings,
                    error=res.stderr[-3000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def ptxas_table(log: str) -> list:
    """[kernel, registers, stack bytes, spill store bytes] for each
    kernel in a ``-Xptxas=-v`` log."""
    out = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            out.append([m.group(1), None, None, None])
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and out:
            out[-1][2:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1][1] = int(m.group(1))
    return out


def prebuild(checkouts) -> dict:
    """Build each checkout's rmsnorm library, all compilers at once;
    returns {checkout: its ptxas_table, or the compiler's error}."""
    code = ("from repro_torch.kernels import build; build.build(['rmsnorm']);"
            " print(build.build_log('rmsnorm'))")
    procs = {c: subprocess.Popen(
        [sys.executable, "-c", code], cwd=c, text=True,
        env=dict(os.environ, PYTHONPATH=str(c / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for c in checkouts}
    out = {}
    for c, p in procs.items():
        log, _ = p.communicate(timeout=600)
        out[str(c)] = ptxas_table(log) if p.returncode == 0 else log[-3000:]
    return out


def _parse_variant(text: str):
    name, _, body = text.partition(":")
    settings = {}
    for item in filter(None, re.split(r",(?=[A-Z_]+=)", body)):
        key, _, value = item.partition("=")
        settings[key] = ast.literal_eval(value)
    return name, settings


def _table(ok, key, lib_key, title):
    print(f"{title}, us a call")
    print(f"{'(B,S,d)':>16} {'type':>8} {'calls':>5} "
          + " ".join(f"{r['name'][:9]:>9}" for r in ok)
          + f" {'F.rms':>7} {'bound':>6}  plan (threads, nv, vec, chunks)")
    for i, row0 in enumerate(ok[0]["rows"]):
        plan = next((r["rows"][i].get("plan") for r in ok
                     if r["name"] == "this"), None)
        print(f"{str(tuple(row0['shape'])):>16} {row0['types'][:8]:>8} "
              f"{row0['calls']:>5} "
              + " ".join(f"{r['rows'][i][key] * 1e3:>9.2f}" for r in ok)
              + f" {row0[lib_key] * 1e3:>7.2f} {row0['bound_ms'] * 1e3:>6.2f}"
              + (f"  {tuple(plan.values())}" if plan else ""))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--batch", default="1,8,16")
    ap.add_argument("--dtype", default="float32,bfloat16")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--settings", default="{}")
    args = ap.parse_args()
    batches = [int(b) for b in args.batch.split(",")]
    dtypes = args.dtype.split(",")
    if args.worker:
        print(json.dumps(worker(json.loads(args.settings), batches,
                                dtypes)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    others = [(o.resolve(), o.resolve().name, {}) for o in args.other]
    t0 = time.perf_counter()
    ptxas = prebuild([ROOT] + [c for c, _, _ in others])
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    for c, table in ptxas.items():
        if isinstance(table, str):
            print(f"[{Path(c).name}] build failed:\n{table}")
            continue
        regs = [t[1] for t in table]
        print(f"[{Path(c).name}] {len(table)} kernels, registers "
              f"{min(regs)}-{max(regs)}, stack <= "
              f"{max(t[2] for t in table)} B, spill stores <= "
              f"{max(t[3] for t in table)} B")
    variants = [_parse_variant(v) for v in args.variant]
    order = (others + [(ROOT, "this", {})]
             + [(ROOT, name, s) for name, s in variants]
             + [(ROOT, "this", {})] + others[::-1])
    runs = []
    for checkout, name, settings in order:
        r = dict(run(checkout, settings, batches, dtypes), name=name)
        runs.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "rows"}),
              flush=True)
    ok = [r for r in runs if "error" not in r]
    if ok:
        _table(ok, "ms", "library_ms", "L2-warm (CUDA graph, same inputs)")
        _table(ok, "cold_ms", "library_cold_ms",
               "L2-cold (CUDA graph rotating over > 50 MB of inputs)")
        for r in ok:
            for row in r["rows"]:
                for who, ks in row.get("trace", {}).items():
                    for k in ks:
                        print(f"[{r['name']}] {str(tuple(row['shape'])):>16}"
                              f" {row['types'][:8]:>8} {who:>7}: grid "
                              f"{k['grid']} block {k['block']} regs "
                              f"{k['registers per thread']} smem "
                              f"{k['shared memory']} blocks/SM "
                              f"{k['blocks per SM']} occupancy "
                              f"{k['est. achieved occupancy %']}% "
                              f"{k['us']} us  {k['name'][:40]}")
        print("launch floor (torch.add on 8 elements, warm), us: "
              + " ".join(f"{r['launch_floor_ms'] * 1e3:.2f}" for r in ok))
        print("host us per call, rmsnorm wrapper | torch.add: "
              + "  ".join(f"{r['host_us']['rmsnorm wrapper']:.1f} | "
                          f"{r['host_us']['torch.add']:.1f}" for r in ok))
        for model, sums in ok[0].get("per_forward_B8", {}).items():
            def col(key, model=model):
                return " ".join(f"{r['per_forward_B8'][model][key]:.4f}"
                                for r in ok)
            print(f"per forward B=8 {model:>15}, ms warm: {col('ms')} | "
                  f"cold: {col('cold_ms')} | F.rms_norm "
                  f"{sums['library_ms']:.4f} / {sums['library_cold_ms']:.4f}"
                  f" | bound {sums['bound_ms']:.4f}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_rmsnorm.json").write_text(
        json.dumps(dict(card=card, ptxas=ptxas, runs=runs), indent=1))
    return 0 if len(ok) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
