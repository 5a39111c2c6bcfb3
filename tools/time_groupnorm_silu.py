"""Time the groupnorm_silu kernel of one or more checkouts on one card.

    python3 tools/time_groupnorm_silu.py [--other DIR ...]
                                         [--variant NAME:KEY=VALUE,...]
                                         [--batch 16,8] [--offset]

At every (H, W, C) shape of one full-width ddim-cifar10 U-Net forward
(chip_smoke.gn_shapes) and each batch of ``--batch``, float32: the
wrapper's device time per call with the method of chip_smoke.py (a CUDA
graph of 20 calls replayed 10 times, L2-warm), beside F.group_norm on
an NCHW copy (GroupNorm only) and the bound (chip_smoke.gn_time_row),
and the sum over the forward's 45 calls.  With ``--other DIR`` (an
unpacked checkout, e.g. the parent commit; may be given more than once)
each runs in a process of its own, in the order others, this, this,
others reversed.  ``--variant NAME:KEY=VALUE,...`` also times this
checkout with constants of ``kernels/groupnorm_silu/ops.py`` replaced
(e.g. ``threads256:THREADS=256``; ``ROW_BYTES=128`` for a tuple of one,
``'ROW_BYTES=(128,64)'``), in the middle of the order; a variant whose
run fails is reported and the others go on.
``--offset`` also holds each run's kernel and the plain version to a
float64 evaluation at x = randn + 100 (the check tests/test_torch_cuda.py
makes).  Prints a table of the runs' times and, per run, one JSON object
of its sums; writes every row to chiprun_out/time_groupnorm_silu.json.
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
OFFSET_SHAPES = ((1, 32, 32, 384), (8, 32, 32, 128))


def _offset_errors(ops, G: int) -> dict:
    """Largest distance of the kernel and the plain version from float64
    at x = randn + 100, per shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.groupnorm_silu.ref import groupnorm_silu_ref
    out = {}
    for B, H, W, C in OFFSET_SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randn((B, H, W, C), generator=gen, device="cuda") + 100
        s = torch.randn(C, generator=gen, device="cuda")
        b = torch.randn(C, generator=gen, device="cuda")
        xd = x.double().reshape(B, H * W, G, C // G)
        mu = xd.mean(dim=(1, 3), keepdim=True)
        var = ((xd - mu) ** 2).mean(dim=(1, 3), keepdim=True)
        want = F.silu(((xd - mu) / torch.sqrt(var + 1e-6)).reshape(x.shape)
                      * s.double() + b.double())
        k = (ops.groupnorm_silu(x, s, b, G).double() - want).abs().max()
        p = (groupnorm_silu_ref(x, s, b, G).double() - want).abs().max()
        out[str((B, H, W, C))] = dict(kernel=float(k), plain=float(p))
    return out


def worker(settings: dict, batches: list, offset: bool) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import gn_shapes, gn_time_row
    from repro_torch.configs.ddim_cifar10 import CONFIG
    from repro_torch.kernels.groupnorm_silu import ops
    for key, value in settings.items():
        if not hasattr(ops, key):
            raise SystemExit(f"ops has no constant {key}")
        setattr(ops, key, value)
    if settings:
        ops.plan.cache_clear()
    torch.backends.cudnn.allow_tf32 = False
    shapes = gn_shapes(CONFIG)
    out = {"checkout": str(Path(ops.__file__).resolve().parents[4]),
           "settings": settings, "rows": []}
    for B in batches:
        rows = [gn_time_row(ops, B, H, W, C, CONFIG.num_groups, calls=n,
                            plain=False)
                for (H, W, C), n in shapes.items()]
        out["rows"] += rows
        out[f"per_forward_B{B}"] = {
            key: sum(r[key] * r["calls"] for r in rows)
            for key in ("ms", "group_norm_ms", "bound_ms")}
    if offset:
        out["offset_max_abs_err"] = _offset_errors(ops, CONFIG.num_groups)
    return out


def run(checkout: Path, settings: dict, batches: list, offset: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--batch", ",".join(map(str, batches)),
           "--settings", json.dumps(settings)] + (["--offset"] if offset
                                                   else [])
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        return dict(checkout=str(checkout), settings=settings,
                    error=res.stderr[-3000:])
    return json.loads(res.stdout.strip().splitlines()[-1])


def _parse_variant(text: str):
    name, _, body = text.partition(":")
    settings = {}
    for item in filter(None, re.split(r",(?=[A-Z_]+=)", body)):
        key, _, value = item.partition("=")
        v = ast.literal_eval(value)
        settings[key] = (v,) if key == "ROW_BYTES" and isinstance(v, int) \
            else v
    return name, settings


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--batch", default="16,8")
    ap.add_argument("--offset", action="store_true")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--settings", default="{}")
    args = ap.parse_args()
    batches = [int(b) for b in args.batch.split(",")]
    if args.worker:
        print(json.dumps(worker(json.loads(args.settings), batches,
                                args.offset)))
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
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    build.build(["groupnorm_silu"])        # the variants share one build
    variants = [_parse_variant(v) for v in args.variant]
    others = [(o.resolve(), o.resolve().name, {}) for o in args.other]
    order = (others + [(ROOT, "this", {})]
             + [(ROOT, name, s) for name, s in variants]
             + [(ROOT, "this", {})] + others[::-1])
    runs = []
    for checkout, name, settings in order:
        r = dict(run(checkout, settings, batches, args.offset), name=name)
        runs.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "rows"}),
              flush=True)
    ok = [r for r in runs if "error" not in r]
    if ok:
        keys = [tuple(r["shape"]) for r in ok[0]["rows"]]
        print(f"{'(B,H,W,C)':>18} {'calls':>5} "
              + " ".join(f"{r['name'][:9]:>9}" for r in ok)
              + f" {'library':>9} {'bound':>7}   (us a call)")
        for i, key in enumerate(keys):
            row0 = ok[0]["rows"][i]
            print(f"{str(key):>18} {row0['calls']:>5} "
                  + " ".join(f"{r['rows'][i]['ms'] * 1e3:>9.2f}" for r in ok)
                  + f" {row0['group_norm_ms'] * 1e3:>9.2f}"
                  f" {row0['bound_ms'] * 1e3:>7.2f}")
        for B in batches:
            print(f"{'per forward B=' + str(B):>24} "
                  + " ".join(f"{r[f'per_forward_B{B}']['ms']:>9.4f}"
                             for r in ok) + "   (ms)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_groupnorm_silu.json").write_text(
        json.dumps(dict(card=card, runs=runs), indent=1))
    return 0 if len(ok) == len(runs) else 1


if __name__ == "__main__":
    sys.exit(main())
