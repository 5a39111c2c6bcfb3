"""Time the decode_attention kernel of two checkouts on one card, in turns.

    python3 tools/time_decode_attention.py [--other DIR] [--targets N,...]

Times ``repro_torch.kernels.decode_attention.ops.decode_attention`` at the
two B=8 decode shapes of the serving path (TinyLlama: q (8,1,32,64) over
a (8,512,4,64) cache; Zamba2: q (8,1,32,80) over (8,512,32,80)), f32 q
over a bf16 cache, cur_len drawn from seed 21 in [1, 512], with the same
method as chip_smoke.py (a CUDA graph of 20 calls replayed 10 times,
L2-warm), beside F.scaled_dot_product_attention on the same inputs and
the bound (valid cache bytes at 3.35 TB/s).  With ``--other DIR`` (an
unpacked checkout, e.g. the parent commit) the two run in separate
processes in the order other, this, this, other.  ``--targets`` also
times this checkout at other values of ``ops.BLOCK_TARGET`` (blocks the
split count aims for).  Prints one JSON object per run and writes all of
them to chiprun_out/time_decode_attention.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {"tinyllama D=64": (8, 512, 32, 4, 64),
          "zamba2 D=80": (8, 512, 32, 32, 80)}
HBM_BYTES_PER_S = 3.35e12


def worker(target: int | None) -> dict:
    import numpy as np
    import torch
    import torch.nn.functional as F
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_time_ms
    from repro_torch.kernels.decode_attention import ops
    if target is not None:
        ops.BLOCK_TARGET = target
    out = {"checkout": str(Path(ops.__file__).resolve().parents[4]),
           "block_target": getattr(ops, "BLOCK_TARGET", None)}
    for name, (B, S, H, KV, D) in SHAPES.items():
        gen = torch.Generator(device="cuda").manual_seed(21)
        q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
        k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        cur = torch.tensor(np.random.default_rng(21).integers(1, S + 1, B),
                           dtype=torch.int32, device="cuda")
        valid = int(cur.sum())
        nbytes = 2 * q.numel() * 4 + B * 4 + 2 * valid * KV * D * 2
        ms = device_time_ms(lambda: ops.decode_attention(q, k, v, cur))
        qt = q.to(torch.bfloat16).transpose(1, 2).contiguous()
        kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
        mask = (torch.arange(S, device="cuda")[None]
                < cur[:, None])[:, None, None, :]
        lib = device_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        splits = (ops.num_splits(B, KV, S) if hasattr(ops, "num_splits")
                  else None)
        out[name] = dict(us=ms * 1e3, sdpa_us=lib * 1e3,
                         bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
                         splits=splits, cur_len=cur.tolist(),
                         kernels_us=_by_kernel(
                             lambda: ops.decode_attention(q, k, v, cur)))
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


def run(checkout: Path, target: int | None) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker"]
    if target is not None:
        cmd += ["--target", str(target)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"worker in {checkout} failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path)
    ap.add_argument("--targets", default="")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--target", type=int)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.target)))
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
    order = ([args.other, ROOT, ROOT, args.other] if args.other
             else [ROOT])
    runs = [run(c.resolve(), None) for c in order]
    runs += [run(ROOT, int(t)) for t in args.targets.split(",") if t]
    for r in runs:
        print(json.dumps(r), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "time_decode_attention.json").write_text(
        json.dumps(dict(card=card, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
