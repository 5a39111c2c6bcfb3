"""Time an attention kernel of one or more checkouts on one card, in turns.

    python3 tools/time_attention.py --kernel {decode_attention,flash_attention}
                                    [--other DIR ...] [--variant NAME:KEY=V,...]
                                    [--batch B] [--shapes NAME,...]

Times the wrapper of ``--kernel`` at its B=8 shapes on the serving path,
with the same method as chip_smoke.py (a CUDA graph of 20 calls
replayed 10 times, L2-warm), beside F.scaled_dot_product_attention on
the same inputs, the bound, and each launched kernel's device time
from torch.profiler:

- decode_attention: f32 q over a bf16 cache, cur_len drawn from seed 21
  in [1, S] (the cross call: every row the whole cache); bound from
  ``ops.cost`` (chip_smoke.py's); the call's plan (kernel, splits,
  grid) and, on the tensor-core path, the blocks an SM holds read from
  the card beside the plan's.  Shapes (B, S, H, KV, D): TinyLlama
  (8,512,32,4,64), Zamba2 (8,512,32,32,80), qwen3 (8,512,32,4,128), the
  VLM's self (8,512,64,8,128) and cross (8,1601,64,8,128) calls,
  granite (8,512,48,1,128).
- flash_attention: the prefill, TinyLlama q (8,128,32,64) with k/v
  (8,128,4,64), Zamba2 q/k/v (8,128,32,80); float32, causal; bound =
  max(bytes at 3.35 TB/s, 3 x operations at 495 TFLOP/s TF32), as
  chip_smoke.py counts it (the kernel's 3xTF32 products).

With ``--other DIR`` (an unpacked checkout, e.g. the parent commit; may
be given more than once) each runs in a process of its own, in the order
others, this, variants, this, others reversed.  ``--variant
NAME:KEY=VALUE,...`` also times this checkout with constants of the
kernel's ``ops.py`` replaced (e.g. ``h8:TC_BLOCK_HEADS=8``; decode's
plan cache is cleared).  ``--batch`` replaces the batch of 8;
``--shapes`` keeps the named shapes only.  Prints one JSON object per
run and a table, and writes all of them to time_<kernel>.json in the
output directory chip_smoke.py writes to.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {
    "decode_attention": {"tinyllama D=64": (8, 512, 32, 4, 64),
                         "zamba2 D=80": (8, 512, 32, 32, 80),
                         "qwen3 G=8": (8, 512, 32, 4, 128),
                         "vlm self G=8": (8, 512, 64, 8, 128),
                         "vlm cross G=8": (8, 1601, 64, 8, 128),
                         "granite G=48": (8, 512, 48, 1, 128)},
    "flash_attention": {"tinyllama D=64": (8, 128, 32, 4, 64),
                        "zamba2 D=80": (8, 128, 32, 32, 80)}}
FULL_ROWS = {"vlm cross G=8"}        # cur_len = S: a cross cache
KERNELS = tuple(SHAPES)


def _decode_case(ops, B, S, H, KV, D, full):
    import numpy as np
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    cur = torch.tensor(np.random.default_rng(21).integers(1, S + 1, B),
                       dtype=torch.int32, device="cuda")
    if full:
        cur.fill_(S)
    c = ops.cost(q, k, v, cur)
    qt = q.to(torch.bfloat16).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(S, device="cuda")[None]
            < cur[:, None])[:, None, None, :]
    extra = dict(cur_len=cur.tolist(), bound_by=c.bound_by)
    p = ops.plan(B, S, H, KV, D, q.dtype, k.dtype) \
        if hasattr(ops, "plan") else None          # a checkout before it
    if p is not None:
        extra.update(path=p.path, splits=p.splits, grid=list(p.grid),
                     heads=p.heads, rows=p.rows)
    if p is not None and p.path == "tensor":
        smem, blocks = ops.tc_occupancy(D, q.dtype, k.dtype, p.heads)
        extra.update(smem=p.smem, smem_card=smem, resident=p.resident,
                     resident_card=blocks)
    return (lambda: ops.decode_attention(q, k, v, cur),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            c.ms * 1e3, extra)


def _flash_case(ops, B, S, H, KV, D, full):
    import torch
    import torch.nn.functional as F
    from chip_smoke import flash_bound
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda")
            for _ in range(2))
    bound_ms, by, _ = flash_bound(q, k)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return (lambda: ops.flash_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True),
            bound_ms * 1e3, dict(bound_by=by))


def worker(kernel: str, settings: dict, batch: int, names: list) -> dict:
    import importlib
    # the checkout's ops first: chip_smoke puts this checkout's src on
    # sys.path, and modules already imported stay the checkout's
    ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_time_ms
    for key, value in settings.items():
        if not hasattr(ops, key):
            raise SystemExit(f"ops has no constant {key}")
        setattr(ops, key, value)
    if settings and hasattr(ops, "plan"):
        ops.plan.cache_clear()
    out = {"kernel": kernel,
           "checkout": str(Path(ops.__file__).resolve().parents[4]),
           "settings": settings, "batch": batch}
    case = _decode_case if kernel == "decode_attention" else _flash_case
    for name, shape in SHAPES[kernel].items():
        if names and name not in names:
            continue
        run, lib, bound_us, extra = case(ops, batch, *shape[1:],
                                         name in FULL_ROWS)
        out[name] = dict(us=device_time_ms(run) * 1e3,
                         sdpa_us=device_time_ms(lib) * 1e3,
                         bound_us=bound_us, kernels_us=_by_kernel(run),
                         **extra)
    return out


def _by_kernel(fn, calls: int = 50) -> dict:
    """Device time per call of each kernel ``fn`` launches, from
    torch.profiler (kernel durations only: no launch gaps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.replace("(anonymous namespace)::", "")[:70]:
            e.self_device_time_total / calls
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def run(checkout: Path, kernel: str, settings: dict, batch: int,
        names: list) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--kernel", kernel, "--batch", str(batch),
           "--settings", json.dumps(settings),
           "--shapes", ",".join(names)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        return dict(checkout=str(checkout), settings=settings,
                    error=res.stderr[-3000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def _parse_variant(text: str):
    name, _, body = text.partition(":")
    settings = {}
    for item in filter(None, re.split(r",(?=[A-Z_]+=)", body)):
        key, _, value = item.partition("=")
        settings[key] = ast.literal_eval(value)
    return name, settings


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=KERNELS, required=True)
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--settings", default="{}")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shapes", default="")
    args = ap.parse_args()
    names = [n for n in args.shapes.split(",") if n]
    if args.worker:
        print(json.dumps(worker(args.kernel, json.loads(args.settings),
                                args.batch, names)))
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
    variants = [(ROOT, *_parse_variant(v)) for v in args.variant]
    order = (others + [(ROOT, "this", {})] + variants
             + [(ROOT, "this", {})] + others[::-1])
    runs = []
    for checkout, name, settings in order:
        r = dict(run(checkout, args.kernel, settings, args.batch, names),
                 name=name)
        runs.append(r)
        print(json.dumps(r), flush=True)
    ok = [r for r in runs if "error" not in r]
    if ok:
        shapes = [n for n in SHAPES[args.kernel] if n in ok[0]]
        print(f"{'shape':>16} " + " ".join(f"{r['name'][:9]:>9}" for r in ok)
              + f" {'library':>9} {'bound':>7}   (us a call)")
        for n in shapes:
            print(f"{n:>16} "
                  + " ".join(f"{r[n]['us']:>9.2f}" if n in r else
                             f"{'-':>9}" for r in ok)
                  + f" {ok[0][n]['sdpa_us']:>9.2f}"
                  f" {ok[0][n]['bound_us']:>7.2f}")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"time_{args.kernel}.json").write_text(
        json.dumps(dict(card=card, runs=runs), indent=1))
    return 0 if len(ok) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
