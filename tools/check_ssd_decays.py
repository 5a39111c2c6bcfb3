"""Hold the ssd_scan kernel of one or more checkouts to the float64 recurrence.

    python3 tools/check_ssd_decays.py [--other DIR ...] [--seeds N]

At the B=8 prefill shape of the Zamba2 serving path (x (8,128,80,64),
B/C (8,128,64), one chunk of 128) and the path's decays (a = dt * A =
-softplus(N(0,1)) at A = -1, so -cum reaches ~100 in the chunk), with x,
B, C and h0 drawn as chip_smoke.py draws them, for seeds 0..N-1: the
largest distance of the kernel's (y, h_final) and of the plain version's
from the float64 recurrence, and their ratio, the quantity chip_smoke.py
bounds by 2 (or 3e-5 absolute).  Also, at the decays of the reference's
sweep (a = -0.2 |N(0,1)|), how far the kernel is from the plain version
in units of chip_smoke.py's float32 tolerance (|got - want| over 3e-5 +
3e-5 |want|; at most 1 passes).  Then the kernel's device time per call
at that shape, with the method of chip_smoke.py (a CUDA graph, L2-warm),
beside chip_smoke.py's bound for it (``ssd_bound``).  With ``--other
DIR`` (an unpacked checkout, e.g. the parent commit; may be given more
than once) each runs in a process of its own, in the order others,
this, this, others reversed; a checkout whose run fails is reported
with its error and the others go on.  Prints one JSON object per run
and writes all of them to chiprun_out/check_ssd_decays.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (8, 128, 80, 64, 64)   # B, S, H, P, N


def worker(seeds: int) -> dict:
    import torch
    sys.path.insert(0, str(ROOT))
    from chip_smoke import _ssd_f64, device_time_ms, ssd_bound
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    B, S, H, P, N = SHAPE
    rows = []
    for seed in range(seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = randn(B, S, H, P)
        b, c = randn(B, S, N) * 0.3, randn(B, S, N) * 0.3
        h0 = randn(B, H, P, N) * 0.1
        a = -torch.nn.functional.softplus(randn(B, S, H))
        exact = _ssd_f64(x, a, b, c, h0)
        off = {who: max(float((got.double() - want).abs().max())
                        for got, want in zip(fn(x, a, b, c, h0), exact))
               for who, fn in (("kernel", ops.ssd_scan),
                               ("plain", ssd_scan_ref))}
        a_ref = -randn(B, S, H).abs() * 0.2
        tol = max(float(((g - w).abs() / (3e-5 + 3e-5 * w.abs())).max())
                  for g, w in zip(ops.ssd_scan(x, a_ref, b, c, h0),
                                  ssd_scan_ref(x, a_ref, b, c, h0)))
        rows.append(dict(seed=seed, **off,
                         ratio=off["kernel"] / off["plain"],
                         of_tolerance=tol))
    ms = device_time_ms(lambda: ops.ssd_scan(x, a, b, c, h0))
    bound, by, _, _ = ssd_bound(x, b, h0, S)
    return {"checkout": str(Path(ops.__file__).resolve().parents[4]),
            "shape": list(SHAPE), "kernel_us": ms * 1e3,
            "bound_us": bound * 1e3, "bound_by": by,
            "max_ratio": max(r["ratio"] for r in rows),
            "max_kernel": max(r["kernel"] for r in rows),
            "max_plain": max(r["plain"] for r in rows),
            "max_of_tolerance": max(r["of_tolerance"] for r in rows),
            "seeds": rows}


def run(checkout: Path, seeds: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--seeds", str(seeds)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        return {"checkout": str(checkout), "error": res.stderr[-4000:]}
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, action="append", default=[])
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--worker", action="store_true")
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.seeds)))
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
    order = ([*args.other, ROOT, ROOT, *reversed(args.other)]
             if args.other else [ROOT])
    runs = [run(c.resolve(), args.seeds) for c in order]
    for r in runs:
        print(json.dumps({k: v for k, v in r.items() if k != "seeds"}),
              flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "check_ssd_decays.json").write_text(
        json.dumps(dict(card=card, runs=runs), indent=1))
    return int(any("error" in r for r in runs))


if __name__ == "__main__":
    sys.exit(main())
