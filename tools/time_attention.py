"""Time an attention kernel of two checkouts on one card, in turns.

    python3 tools/time_attention.py --kernel {decode_attention,flash_attention}
                                    [--other DIR] [--targets N,...]
                                    [--batch B]

Times the wrapper of ``--kernel`` at its two B=8 shapes on the serving
path, with the same method as chip_smoke.py (a CUDA graph of 20 calls
replayed 10 times, L2-warm), beside F.scaled_dot_product_attention on
the same inputs, the bound, and each launched kernel's device time
from torch.profiler:

- decode_attention: TinyLlama q (8,1,32,64) over a (8,512,4,64) cache,
  Zamba2 q (8,1,32,80) over (8,512,32,80); f32 q over a bf16 cache,
  cur_len drawn from seed 21 in [1, 512]; bound = valid cache bytes at
  3.35 TB/s.
- flash_attention: the prefill, TinyLlama q (8,128,32,64) with k/v
  (8,128,4,64), Zamba2 q/k/v (8,128,32,80); float32, causal; bound =
  max(bytes at 3.35 TB/s, 3 x operations at 495 TFLOP/s TF32), as
  chip_smoke.py counts it (the kernel's 3xTF32 products).

With ``--other DIR`` (an unpacked checkout, e.g. the parent commit) the
two run in separate processes in the order other, this, this, other.
``--targets`` (decode_attention only) also times this checkout at other
values of ``ops.BLOCK_TARGET`` (blocks the split count aims for).
``--batch`` replaces the batch of 8 (e.g. to see the kernel past its
first waves).
Prints one JSON object per run and writes all of them to
time_<kernel>.json in the output directory chip_smoke.py writes to.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = {
    "decode_attention": {"tinyllama D=64": (8, 512, 32, 4, 64),
                         "zamba2 D=80": (8, 512, 32, 32, 80)},
    "flash_attention": {"tinyllama D=64": (8, 128, 32, 4, 64),
                        "zamba2 D=80": (8, 128, 32, 32, 80)}}
KERNELS = tuple(SHAPES)


def _decode_case(ops, B, S, H, KV, D):
    import numpy as np
    import torch
    import torch.nn.functional as F
    from chip_smoke import HBM_BYTES_PER_S
    gen = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
    k, v = (torch.randn((B, S, KV, D), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    cur = torch.tensor(np.random.default_rng(21).integers(1, S + 1, B),
                       dtype=torch.int32, device="cuda")
    valid = int(cur.sum())
    nbytes = 2 * q.numel() * 4 + B * 4 + 2 * valid * KV * D * 2
    qt = q.to(torch.bfloat16).transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(S, device="cuda")[None]
            < cur[:, None])[:, None, None, :]
    splits = (ops.num_splits(B, KV, S) if hasattr(ops, "num_splits")
              else None)
    return (lambda: ops.decode_attention(q, k, v, cur),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True),
            nbytes / HBM_BYTES_PER_S * 1e6,
            dict(splits=splits, cur_len=cur.tolist()))


def _flash_case(ops, B, S, H, KV, D):
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


def worker(kernel: str, target: int | None, batch: int) -> dict:
    import importlib
    sys.path.insert(0, str(ROOT))
    from chip_smoke import device_time_ms
    ops = importlib.import_module(f"repro_torch.kernels.{kernel}.ops")
    if target is not None:
        ops.BLOCK_TARGET = target
    out = {"kernel": kernel,
           "checkout": str(Path(ops.__file__).resolve().parents[4]),
           "block_target": getattr(ops, "BLOCK_TARGET", None),
           "batch": batch}
    case = _decode_case if kernel == "decode_attention" else _flash_case
    for name, shape in SHAPES[kernel].items():
        run, lib, bound_us, extra = case(ops, batch, *shape[1:])
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


def run(checkout: Path, kernel: str, target: int | None,
        batch: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--kernel", kernel, "--batch", str(batch)]
    if target is not None:
        cmd += ["--target", str(target)]
    res = subprocess.run(cmd, cwd=checkout, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"worker in {checkout} failed:\n{res.stderr}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=KERNELS, required=True)
    ap.add_argument("--other", type=Path)
    ap.add_argument("--targets", default="")
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--target", type=int)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if args.targets and args.kernel != "decode_attention":
        ap.error("--targets applies to decode_attention only")
    if args.worker:
        print(json.dumps(worker(args.kernel, args.target, args.batch)))
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
    runs = [run(c.resolve(), args.kernel, None, args.batch) for c in order]
    runs += [run(ROOT, args.kernel, int(t), args.batch)
             for t in args.targets.split(",") if t]
    for r in runs:
        print(json.dumps(r), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"time_{args.kernel}.json").write_text(
        json.dumps(dict(card=card, runs=runs), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
