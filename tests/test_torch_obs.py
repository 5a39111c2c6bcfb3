"""The port's span recorder (``repro_torch.obs``) and the spans the
round, the closed loop, the bucketed engine and the serving engine
record under a profiler, on the CPU."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.api import Provisioner
from repro_torch.api.workloads import DecodeWorkload, DiffusionWorkload
from repro_torch.configs.ddim_cifar10 import SMOKE
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.execution import shape_bucket
from repro_torch.core.plan import BatchPlan
from repro_torch.core.service import make_scenario

ROUND = {"round", "allocate", "plan", "validate", "simulate", "execute",
         "session.open", "session.finish", "loop.batch"}
ENGINE = {"engine.batch", "engine.prep", "engine.launch", "engine.wait"}
# the span each span opens under (table of PERF.md §3)
PARENT = {"allocate": {"round"}, "plan": {"round"},
          "validate": {"round"}, "simulate": {"round"},
          "execute": {"round"}, "session.open": {"execute"},
          "session.finish": {"execute"}, "loop.batch": {"execute"},
          "loop.replan": {"execute"}, "engine.batch": {"loop.batch"},
          "engine.prep": {"engine.batch"},
          "engine.launch": {"engine.batch"},
          "engine.wait": {"engine.batch"},
          "engine.capture": {"engine.prep"},
          "serving.decode": {"loop.batch"},
          "serving.prefill": {"serving.decode"}}


@pytest.fixture(autouse=True)
def clean():
    obs.take()
    yield
    obs.take()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def smoke_workload():
    return DiffusionWorkload(cfg=SMOKE, device="cpu",
                             exec_engine="bucketed")


def bucketed_round(wl):
    """A closed round on the bucketed engine at the smoke U-Net."""
    return Provisioner(make_scenario(K=4, tau_min=0.3, tau_max=0.6,
                                     seed=4),
                       workload=wl, allocator="inv_se",
                       delay=DelayModel(0.01, 0.05), device="cpu")


def simulated_round(_):
    """A closed round on ``SimulatedSession`` whose true g is twice the
    planner's, so the loop replans."""
    return Provisioner(
        make_scenario(K=5, seed=1), scheduler="stacking",
        allocator="inv_se", delay=DelayModel(0.05, 0.1),
        execute_kwargs={"executor": "simulated",
                        "executor_kwargs": {
                            "true_delay": DelayModel(0.1, 0.2)},
                        "min_batches": 2, "drift_tol": 0.2})


SETUPS = {"bucketed": (bucketed_round, ROUND | ENGINE),
          "simulated": (simulated_round, ROUND | {"loop.replan"})}


def traced_round(make, wl):
    p = make(wl)
    t_before = time.perf_counter()
    with cpu_profile():
        rep = p.run(execute="closed")
    t_after = time.perf_counter()
    return rep, obs.take(), t_before, t_after


def test_gate_attribute_present():
    """The gate is the flag ``torch.profiler.profile`` sets; a torch
    without it would leave every span off silently."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    with obs.span("off"):
        pass
    with cpu_profile():
        with obs.span("on"):
            pass
    with obs.span("off"):
        pass
    assert [s.name for s in obs.spans()] == ["on"]


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_no_profiler_no_span(setup, smoke_workload):
    rep = SETUPS[setup][0](smoke_workload).run(execute="closed")
    assert len(rep.execution.records) > 0
    assert obs.spans() == []


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_round_records_every_span(setup, smoke_workload):
    make, names = SETUPS[setup]
    rep, spans, t_before, t_after = traced_round(make, smoke_workload)
    assert {s.name for s in spans} == names
    root = spans[0]
    assert root.name == "round" and root.parent == -1
    assert root.attrs == {"K": rep.scenario.K}
    for i, s in enumerate(spans):
        assert s.round == 0
        assert t_before <= s.t0 <= s.t1 <= t_after
        if i:
            parent = spans[s.parent]
            assert parent.name in PARENT[s.name], (s.name, parent.name)
            assert parent.t0 <= s.t0 and s.t1 <= parent.t1
    one = {n: [s for s in spans if s.name == n] for n in names}
    for n in ("round", "allocate", "plan", "validate", "simulate",
              "execute", "session.open", "session.finish"):
        assert len(one[n]) == 1, n
    ex = rep.execution
    assert one["execute"][0].attrs == {"loop_clock_s": ex.wall_clock}
    assert [(s.attrs["size"], s.attrs["predicted_s"],
             s.attrs["measured_s"]) for s in one["loop.batch"]] == \
        [(r.size, r.predicted_s, r.measured_s) for r in ex.records]
    replans = one.get("loop.replan", [])
    assert len(replans) == ex.replans
    assert setup == "bucketed" or ex.replans >= 1
    # a replan runs after the batch that tripped it
    for s in replans:
        done = [b for b in one["loop.batch"] if b.t1 <= s.t0]
        assert s.attrs == {"batches": len(done)}


def test_engine_batch_rows_and_bucket(smoke_workload):
    rep, spans, _, _ = traced_round(bucketed_round, smoke_workload)
    batches = [s for s in spans if s.name == "engine.batch"]
    sizes = [r.size for r in rep.execution.records]
    assert rep.execution.replans == 0
    assert sizes == rep.plan.batch_sizes()
    assert [(s.attrs["rows"], s.attrs["bucket"]) for s in batches] == \
        [(n, shape_bucket(n)) for n in sizes]
    for b in batches:
        kids = [s.name for s in spans if spans[s.parent] is b]
        assert kids == ["engine.prep", "engine.wait", "engine.launch",
                        "engine.wait"]


def test_scan_chunks_are_engine_batches(smoke_workload):
    """An untimed run fuses stable phases into multi-step programs: each
    chunk is one ``engine.batch`` with its ``steps``."""
    ex = smoke_workload._ex()
    # three services for 3 steps, then two for 4 more: two stable phases
    batches = [[(k, n) for k in (0, 1, 2)] for n in range(3)] + \
        [[(k, n) for k in (0, 1)] for n in range(3, 7)]
    plan = BatchPlan(batches=batches, start_times=[0.0] * 7,
                     steps_completed={0: 7, 1: 7, 2: 3},
                     delay=DelayModel())
    with cpu_profile():
        ex.run(plan, exec_engine="bucketed")
    spans = obs.take()
    batches = [s for s in spans if s.name == "engine.batch"]
    assert [(s.attrs["rows"], s.attrs["bucket"], s.attrs.get("steps"))
            for s in batches] == [(3, 4, 2), (3, 4, None), (2, 2, 4)]
    assert sum(s.attrs["rows"] * s.attrs.get("steps", 1)
               for s in batches) == sum(plan.batch_sizes())
    assert all(s.round == -1 for s in spans)


def test_capture_span_shares_the_compile_log_reading(smoke_workload):
    ex = smoke_workload._ex()
    key = ("obs-test", 1)
    with cpu_profile():
        with obs.span("engine.prep"):
            ex.program(key, lambda: "program")
            ex.program(key, lambda: "rebuilt")      # cached: no span
    spans = obs.take()
    assert [s.name for s in spans] == ["engine.prep", "engine.capture"]
    cap = spans[1]
    assert cap.parent == 0 and cap.attrs == {"key": repr(key)}
    assert ex.compile_log[-1] == (key, cap.t1 - cap.t0)
    ex.program(("obs-test", 2), lambda: "program")
    assert obs.spans() == [] and ex.compile_log[-1][0] == ("obs-test", 2)


def test_serving_prefill_per_group_and_decode_per_batch():
    """A smoke ``ServingEngine`` decode: one ``serving.prefill`` per new
    group of equal-length prompts, inside the first batch that holds
    it, and one ``serving.decode`` per batch."""
    eng = DecodeWorkload(device="cpu", max_len=32)._eng()
    eng.delay = DelayModel(a=0.002, b=0.02)
    for n, d in ((4, 0.05), (4, 0.1), (6, 0.1)):
        eng.submit(np.arange(n, dtype=np.int32), d)
    plan = eng.plan()
    with cpu_profile():
        eng.execute(plan)
    spans = obs.take()
    decodes = [s for s in spans if s.name == "serving.decode"]
    prefills = [s for s in spans if s.name == "serving.prefill"]
    assert [s.attrs["rows"] for s in decodes] == plan.batch_sizes()
    assert sorted(s.attrs["rows"] for s in prefills) == [1, 2]
    assert all(spans[s.parent].name == "serving.decode" for s in prefills)
    assert spans[prefills[0].parent] is decodes[0]
    assert eng.prefill_calls == 2


def test_nesting_rounds_and_take():
    with cpu_profile():
        with obs.span("outside"):
            pass
        for _ in range(2):
            with obs.span("round", K=1):
                with obs.span("execute") as sp:
                    sp.set(loop_clock_s=0.5)
                    obs.record("engine.capture", 1.0, 2.0, key="k")
                    with obs.span("round"):         # a nested round
                        pass
    spans = obs.spans()
    assert [(s.name, s.parent, s.round) for s in spans] == [
        ("outside", -1, -1),
        ("round", -1, 1), ("execute", 1, 1), ("engine.capture", 2, 1),
        ("round", 2, 1),
        ("round", -1, 5), ("execute", 5, 5), ("engine.capture", 6, 5),
        ("round", 6, 5)]
    assert spans[2].attrs == {"loop_clock_s": 0.5}
    assert (spans[3].t0, spans[3].t1) == (1.0, 2.0)
    assert len(obs.take()) == 9 and obs.spans() == []


def test_threads_nest_apart():
    """Each thread's spans nest under that thread's open spans."""
    seen = {}

    def worker():
        with obs.span("round") as r:
            seen["thread"] = r

    with cpu_profile():
        with obs.span("round") as main:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert main.parent == -1 and seen["thread"].parent == -1
    assert seen["thread"].round != main.round


def test_off_cost_under_a_microsecond():
    """No profiler: a span is one flag check and a shared no-op context.
    The thread's CPU time, least of many repeats, so that a host whose
    cores other processes share does not fail it."""
    n = 10000

    def per_span():
        t0 = time.thread_time()
        for _ in range(n):
            with obs.span("engine.prep"):
                pass
        return (time.thread_time() - t0) / n

    best = min(per_span() for _ in range(15))
    assert obs.spans() == []
    assert best < 1e-6, f"{best * 1e9:.0f} ns a span"
