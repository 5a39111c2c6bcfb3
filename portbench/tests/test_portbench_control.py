"""The control on the card: the reference one precision below the
configuration's (TF32 for float32) put in the program's place fails the
cell's comparison, while the program passes it, on a short window at
the cell's own sizes.  Needs the card (and deepseek's 63 GiB of
weights: run it with the card to itself); skips without one."""

import json
import sys
import time
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(PB))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PENDING = json.loads((PB / "pending.json").read_text())
# the manifest with the pending cells' entries beside its own
BENCH_ALL = dict(BENCH, **{
    k: BENCH[k] + [e for e in PENDING[k]
                   if e["name"] not in {x["name"] for x in BENCH[k]}]
    for k in ("configs", "workloads", "per_layer")})
COMPARED = {"ddim-k32-stack": "image_err",
            "dsmoe-k8-decode": "mismatch_share"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(COMPARED))
def test_control_fails_where_the_program_passes(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's "
                    "sizes on the chip")
    from harness.bench import load_cell, run_driver
    cell_, traffic, cfg, ref, drv = load_cell(BENCH_ALL, cell)
    driver = drv.Driver(cfg, traffic, ref, 2**31 + 977, "cuda")
    res = run_driver(BENCH_ALL, cell_, driver, 3.0, False, time.perf_counter())
    name = COMPARED[cell]
    limit = res["checks"][name]["limit"]
    assert res["correct"], res["checks"]
    assert drv.control(driver)[name] > limit
