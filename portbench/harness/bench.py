"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the metrics, found by name.

Everything a cell needs is found from ``BENCHMARK.json`` by name: the
cell's traffic file ``portbench/workloads/<traffic>.json``, its
configuration's file (``configs[].file``) and the reference that file
names, the driver the configuration names
(``portbench/drivers/<driver>.py``), and a reader per metric
(``portbench/metrics/<metric>.py``, ``read(ctx) -> float | None``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict

from harness import checks, frozen
from harness.loop import Rounds, outcomes
from harness.traffic import WARMUP_ROUND, rng, round_requests

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(bench: dict, cell_name: str):
    """(cell entry, traffic, configuration, reference module, driver
    module) of a cell named in the manifest."""
    cell = next((w for w in bench["workloads"] if w["name"] == cell_name),
                None)
    if cell is None:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json "
                       f"({[w['name'] for w in bench['workloads']]})")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    traffic = json.loads(
        (PORTBENCH / "workloads" / f"{cell['traffic']}.json").read_text())
    cfg = json.loads((ROOT / conf["file"]).read_text())
    ref = load_module(ROOT / cfg["reference"], f"ref_{cfg['driver']}")
    drv = load_module(PORTBENCH / "drivers" / f"{cfg['driver']}.py",
                      f"driver_{cfg['driver']}")
    return cell, traffic, cfg, ref, drv


def metrics_of(bench: dict, cell_name: str, trace: bool):
    """The manifest's metric entries this cell reports in this mode."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


class Context:
    """What a metric reader sees of a run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def counts(self, name: str):
        """The frozen count module ``portbench/counts/<name>.py``."""
        counts = str(PORTBENCH / "counts")
        if counts not in sys.path:
            sys.path.insert(0, counts)
        return load_module(PORTBENCH / "counts" / f"{name}.py",
                           f"counts_{name}")

    def spans(self, rounds):
        """(name, host start, host end) of every span of the rounds:
        a round, each planner call (``plan``) and each batch."""
        out = []
        for log in rounds:
            out.append(("round", log.t0, log.t1))
            out += [("plan", c.t0, c.t1) for c in log.calls]
            out += [("batch", b[1], b[2]) for b in log.batches]
        return out


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float,
             trace: bool, t_process0: float):
    """Run the cell once on the card; returns the result dict (and
    prints nothing)."""
    cell, traffic, cfg, ref, drv = load_cell(bench, cell_name)
    return run_driver(bench, cell, drv.Driver(cfg, traffic, ref, seed,
                                              "cuda"),
                      seconds, trace, t_process0)


def run_driver(bench: dict, cell: dict, driver, seconds: float,
               trace: bool, t_process0: float):
    """Set-up, the window, the metrics and the comparison, for a driver
    built from the cell's configuration, traffic and seed (the CPU
    tests build one at smoke sizes)."""
    import torch
    cell_name, traffic, cfg = cell["name"], driver.traffic, driver.cfg
    seed, cuda = driver.seed, driver.device == "cuda"
    quality_cls = frozen.QUALITY[cfg["quality"]]

    driver.setup()
    rounds = Rounds(driver, traffic)
    rounds.run(WARMUP_ROUND, round_requests(traffic, seed, WARMUP_ROUND))
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process0

    logs = []
    t_w0 = time.perf_counter()
    r = 0
    while time.perf_counter() - t_w0 < seconds:
        logs.append(rounds.run(r, round_requests(traffic, seed, r)))
        r += 1
    window_s = time.perf_counter() - t_w0
    # a traced run profiles rounds of its own after the window, so the
    # window's spans and rates are those of an untraced run
    tracer, traced = None, []
    if trace and cuda:
        from harness.trace import Tracer
        tracer = Tracer()
        tracer.start()
        for r in range(r, r + int(traffic.get("trace_rounds", 1))):
            traced.append(rounds.run(r, round_requests(traffic, seed, r)))
        tracer.stop()
    mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0

    outs = [o for log in logs for o in outcomes(log, traffic,
                                                quality_cls())]
    ctx = Context(rounds=logs, traced_rounds=traced, outcomes=outs,
                  window_s=window_s, setup_s=setup_s, tracer=tracer,
                  traffic=traffic,
                  cfg=cfg, driver=driver, cell=cell)
    values: Dict[str, dict] = {}
    for m in metrics_of(bench, cell_name, trace):
        reader = load_module(PORTBENCH / "metrics" / f"{m['name']}.py",
                             f"metric_{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    breakdown = tracer.breakdown(ctx.spans(traced)) if tracer else None

    # the comparison: the program's state is freed first, then the
    # references run
    driver.release()
    del rounds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = traffic["limits"]
    found: Dict[str, float] = {}
    try:
        c_rng = rng(seed, 7)
        found["plan_mismatch"] = checks.plan_mismatch(
            logs + traced, c_rng, quality_cls, traffic["allocator"],
            traffic["check"]["first_plans"], traffic["check"]["replans"])
        found["exec_mismatch"] = checks.exec_mismatch(logs + traced)
        found.update(driver.check(logs + traced, c_rng))
    except Exception:              # a fault that breaks the comparison
        traceback.print_exc(file=sys.stderr)
        found["check_error"] = 1.0
        limits = dict(limits, check_error=0.0)
    compared = {k: {"value": float(v), "limit": float(limits[k])}
                for k, v in found.items() if k in limits}
    correct = bool(compared) and all(
        c["value"] <= c["limit"] for c in compared.values())
    result = {
        "correct": correct,
        "attempted": len(outs),
        "failed": sum(o["steps"] == 0 for o in outs),
        "metrics": values,
        "device": device_info(cuda, mem_peak, tracer),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    readings = {k: float(v) for k, v in found.items() if k not in limits}
    if readings:
        result["readings"] = readings     # read beside the checks
    result["window"] = window_summary(logs, window_s)
    result["checks"] = compared           # last: each number and its limit
    return result


def window_summary(logs, window_s: float) -> dict:
    """Where the window's seconds went, for reading a run's spread: the
    planner's calls (first plans and replans), the batches (host clock
    around each ``run_batch``), the rest (the facade's glue and the
    gaps between rounds), and the quartiles of the rounds' own rates."""
    plan_s = sum(c.t1 - c.t0 for log in logs for c in log.calls)
    batch_s = sum(b[2] - b[1] for log in logs for b in log.batches)
    rates = [sum(len(b[0]) for b in log.batches) / (log.t1 - log.t0)
             for log in logs if log.t1 > log.t0]
    return {"rounds": len(logs),
            "batches": sum(len(log.batches) for log in logs),
            "replans": sum(len(log.schedule_calls()) - 1 for log in logs),
            "plan_s": plan_s, "batch_s": batch_s,
            "other_s": window_s - plan_s - batch_s,
            "round_steps_per_s": quartiles(rates)}


def quartiles(v) -> list:
    import statistics
    return statistics.quantiles(v, n=4) if len(v) > 1 else list(v)


def set_tf32(on: bool) -> None:
    """TF32 for float32 products and convolutions on (the control's
    precision) or off (the configurations')."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def device_info(cuda: bool, mem_peak: int, tracer) -> dict:
    import torch
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": 1, "memory_peak_bytes": mem_peak}
    if tracer is not None:
        d["busy_s"] = tracer.busy_s
        d["window_s"] = tracer.window_s
    return d
