"""Device memory the bucketed engine's CUDA graphs hold, against the
number of distinct service counts K one executor has seen.

    python3 tools/check_graph_memory.py [--ks 2 3 4 5 6 7 8 9 10 11 12]

One full-width ddim-cifar10 executor runs, for each K in turn, a plan
over K services whose batches shrink from K to 1 (each size twice, so
the untimed run captures two-step graphs), untimed and then timed (one
step a graph).  After each K: the pool rows the session used, graphs
held, memory allocated and reserved after ``torch.cuda.empty_cache()``
(what stays reserved beyond allocated is the graphs' shared pool), and
the capture seconds of that K.  Prints one line a K and writes them to
chiprun_out/check_graph_memory.json.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _plan(K):
    from repro_torch.core.delay_model import DelayModel
    from repro_torch.core.plan import BatchPlan
    counts = {k: 2 * (k + 1) for k in range(K)}
    rem, done, batches = dict(counts), {k: 0 for k in counts}, []
    while any(rem.values()):
        ks = sorted(k for k, v in rem.items() if v)
        batches.append([(k, done[k]) for k in ks])
        for k in ks:
            rem[k] -= 1
            done[k] += 1
    return BatchPlan(batches=batches, start_times=[0.0] * len(batches),
                     steps_completed=counts, delay=DelayModel())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ks", type=int, nargs="+",
                    default=list(range(2, 13)))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("check_graph_memory: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.ddim_cifar10 import CONFIG
    from repro_torch.diffusion import unet
    from repro_torch.diffusion.executor import BatchDenoisingExecutor
    from repro_torch.models.params import init_params
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    params = init_params(unet.schema(CONFIG),
                         torch.Generator().manual_seed(0), "cpu")
    ex = BatchDenoisingExecutor(CONFIG, params, device="cuda")
    shape = (CONFIG.image_size, CONFIG.image_size, CONFIG.in_channels)
    rows = []
    for K in args.ks:
        plan = _plan(K)
        rng = np.random.default_rng(K)
        lat = {k: rng.standard_normal(shape).astype(np.float32)
               for k in range(K)}
        n0 = len(ex.compile_log)
        t0 = time.perf_counter()
        sess = ex.open_session(plan, latents=lat, exec_engine="bucketed")
        sess.run_plan([[k for k, _ in b] for b in plan.batches])
        pool_rows = sess._pool.rows
        sess.finish()
        ex.run(plan, latents=lat, timed=True, exec_engine="bucketed")
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc, res = torch.cuda.memory_allocated(), \
            torch.cuda.memory_reserved()
        row = dict(K=K, pool_rows=pool_rows, pool_sizes=len(ex._pools),
                   graphs=len(ex._programs),
                   captures_this_K=len(ex.compile_log) - n0,
                   capture_s_this_K=sum(s for _, s in ex.compile_log[n0:]),
                   wall_s=wall, allocated_mib=alloc / 2**20,
                   reserved_mib=res / 2**20,
                   beyond_allocated_mib=(res - alloc) / 2**20)
        rows.append(row)
        print(" ".join(f"{k}={v:.4g}" if isinstance(v, float)
                       else f"{k}={v}" for k, v in row.items()), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "check_graph_memory.json").write_text(json.dumps(
        dict(card=card, torch=torch.__version__, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
