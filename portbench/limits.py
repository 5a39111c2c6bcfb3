"""Read the numbers a cell's limits are set from: the program's compared
numbers over many seeds and the control's (the reference one precision
below the configuration's in the program's place), in one process, set
up anew for each seed, each at the cell's own load over a short window.

    python3 portbench/limits.py --workload <cell> --seeds 101-112 \
        --control-seeds 3 --seconds 3

Prints one JSON line per seed (the program's and, for the first
``--control-seeds`` seeds, the control's numbers) and, last, the
largest program reading and the smallest control reading of each
number.  The control is each driver module's ``control(driver)``,
over what the run's check compared; the benchmark's own runs never
call it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def seeds_of(spec: str):
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(HERE)]
    from harness.bench import load_cell, run_driver
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    lower, upper = {}, {}
    for i, seed in enumerate(seeds_of(args.seeds)):
        t0 = time.perf_counter()
        cell, traffic, cfg, ref, drv = load_cell(bench, args.workload)
        driver = drv.Driver(cfg, traffic, ref, seed, "cuda")
        res = run_driver(bench, cell, driver, args.seconds, False, t0)
        nums = {k: c["value"] for k, c in res["checks"].items()}
        nums.update(res.get("readings", {}))
        for k, v in nums.items():
            lower[k] = max(lower.get(k, float("-inf")), v)
        if i < args.control_seeds:
            for k, v in drv.control(driver).items():
                nums[f"{k}_control"] = v
                upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "seconds": time.perf_counter() - t0, **nums}),
              flush=True)
        del res, driver
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper,
                      "total_s": time.perf_counter() - T0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
