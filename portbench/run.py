"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as its last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; the numbers it
compared, each with its limit, come last there (``checks``) and as the
last lines of standard error.  Exits non-zero, printing no result, with
no card (or fewer than the cell asks for), or where ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the window has closed.
"""

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Module names that may not be loaded in the process that prints the
# result, compared by whole top-level name (the port's own top-level
# name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_loaded(modules=None):
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def cache_env(root: Path) -> None:
    """Fixed cache directories inside the checkout: what the program
    builds (nvcc's libraries go to ``build/repro_torch`` by the
    program's own rule) and any extension or Triton cache."""
    cache = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env(ROOT)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card and does "
              "not fall back to the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"cell {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    from harness.bench import run_cell
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), T_PROCESS0)
    found = forbidden_loaded()
    if found:
        print(f"forbidden modules loaded in the benchmark process: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
