"""The readers of the program's spans (``harness/spans.py``): on a
synthetic context with known idle gaps and spans, and on rounds run
through the harness on the CPU at smoke sizes under a profiler."""

import json
import sys
import time
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(PB))

from harness.bench import Context, load_cell, load_module  # noqa: E402
from harness.traffic import round_requests  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.core.execution import shape_bucket  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = ["idle_planner_pct", "idle_engine_pct", "idle_loop_pct",
                "bucket_fill_pct", "unclocked_ms", "prefill_ms"]
IDLE = {"idle_planner_pct": "planner", "idle_engine_pct": "engine",
        "idle_loop_pct": "loop"}


def reader(name):
    return load_module(PB / "metrics" / f"{name}.py", f"metric_{name}")


class FakeTracer:
    """The parts of ``harness.trace.Tracer`` the readers use."""

    def __init__(self, t0, t1, gaps):
        self.t0, self.t1, self.gaps = t0, t1, list(gaps)
        self.window_s = t1 - t0
        self.busy_s = self.window_s - sum(d for _, d in self.gaps)


def span(name, t0, t1, parent=-1, **attrs):
    s = obs.Span(name, attrs)
    s.t0, s.t1, s.parent = t0, t1, parent
    return s


# a traced window 0-10 s: one round whose two batches a replan parts,
# and a round after the window
SPANS = [
    span("round", 1.0, 9.0, K=4),                          # 0
    span("allocate", 1.5, 2.0, 0),                         # 1
    span("plan", 2.0, 2.5, 0),                             # 2
    span("execute", 3.0, 8.5, 0, loop_clock_s=4.0),        # 3
    span("loop.batch", 3.2, 5.0, 3),                       # 4
    span("engine.batch", 3.3, 4.9, 4, rows=3, bucket=4),   # 5
    span("engine.wait", 3.3, 3.4, 5),                      # 6
    span("engine.launch", 3.4, 3.5, 5),                    # 7
    span("engine.wait", 3.5, 4.8, 5),                      # 8
    span("loop.replan", 5.2, 6.0, 3, batches=1),           # 9
    span("loop.batch", 6.1, 8.0, 3),                       # 10
    span("engine.batch", 6.1, 7.9, 10, rows=1, bucket=2),  # 11
    span("round", 10.5, 11.5, K=4),                        # 12
    span("execute", 10.6, 11.4, 12, loop_clock_s=0.1),     # 13
    span("engine.batch", 10.7, 11.3, 13, rows=1, bucket=32),  # 14
    span("allocate", 10.2, 10.4),                          # 15
]
# idle gaps (host start, seconds): the harness's and the round's own
# time, then one that opens inside engine.wait and runs through the
# replan, then the harness's
GAPS = [(0.5, 1.2), (4.0, 2.0), (9.5, 0.5)]
# by hand: planner allocate 0.2 + replan 0.8; engine wait 0.8 + batch
# 0.1; loop round 0.5 + loop.batch 0.1 + execute 0.2; harness 0.5 + 0.5
WANT = {"idle_planner_pct": 10.0, "idle_engine_pct": 9.0,
        "idle_loop_pct": 8.0, "harness": 10.0}


@pytest.fixture
def synthetic(monkeypatch):
    monkeypatch.setattr(obs, "spans", lambda: list(SPANS))
    return Context(tracer=FakeTracer(0.0, 10.0, GAPS), traced_rounds=[])


@pytest.mark.parametrize("name", list(IDLE))
def test_idle_shares_by_hand(synthetic, name):
    assert reader(name).read(synthetic) == pytest.approx(WANT[name],
                                                         abs=1e-9)


def test_idle_shares_and_harness_sum_to_device_idle(synthetic):
    from harness.spans import idle_pct_by_layer
    split = idle_pct_by_layer(synthetic)
    assert split["harness"] == pytest.approx(WANT["harness"], abs=1e-9)
    assert split["serving"] == split["other"] == 0.0
    three = sum(reader(n).read(synthetic) for n in IDLE)
    idle = reader("device_idle_pct").read(synthetic)
    assert idle == pytest.approx(37.0, abs=1e-9)
    assert abs(three + split["harness"] - idle) < 1e-9


def test_gap_split_across_wait_and_replan(monkeypatch):
    """A gap that opens inside ``engine.wait`` and runs through a
    ``loop.replan`` goes to both layers by time, not all to the engine."""
    monkeypatch.setattr(obs, "spans", lambda: list(SPANS))
    ctx = Context(tracer=FakeTracer(0.0, 10.0, [(4.0, 2.0)]))
    got = {n: reader(n).read(ctx) for n in IDLE}
    assert got == pytest.approx({"idle_planner_pct": 8.0,
                                 "idle_engine_pct": 9.0,
                                 "idle_loop_pct": 3.0}, abs=1e-9)


def test_spans_outside_the_window_ignored(synthetic):
    """The round after the window (its 32-row bucket, its allocate, its
    clock) and a gap there change nothing."""
    assert reader("bucket_fill_pct").read(synthetic) == \
        pytest.approx(100.0 * 4 / 6)
    assert reader("unclocked_ms").read(synthetic) == \
        pytest.approx(1e3 * (8.0 - 4.0))
    wide = Context(tracer=FakeTracer(0.0, 10.0, GAPS + [(10.1, 0.5)]))
    split = {n: reader(n).read(wide) for n in IDLE}
    assert split == pytest.approx({n: WANT[n] for n in IDLE}, abs=1e-9)


def test_prefill_ms_per_batch_that_prefills(monkeypatch):
    spans = [span("loop.batch", 0.0, 1.0),
             span("serving.decode", 0.0, 1.0, 0, rows=3),
             span("serving.prefill", 0.1, 0.3, 1, rows=2),
             span("serving.prefill", 0.3, 0.4, 1, rows=1),
             span("serving.decode", 1.0, 2.0, rows=3),
             span("serving.decode", 2.0, 3.0, rows=1),
             span("serving.prefill", 2.1, 2.2, 5, rows=1),
             span("serving.prefill", 12.0, 13.0, 5, rows=1)]
    monkeypatch.setattr(obs, "spans", lambda: spans)
    ctx = Context(tracer=FakeTracer(0.0, 10.0, []))
    assert reader("prefill_ms").read(ctx) == pytest.approx(
        1e3 * (0.3 + 0.1) / 2)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_none_without_tracer_or_spans(name, monkeypatch):
    assert reader(name).read(Context(tracer=None, traced_rounds=[])) \
        is None
    monkeypatch.setattr(obs, "spans", lambda: [])
    assert reader(name).read(
        Context(tracer=FakeTracer(0.0, 1.0, []), traced_rounds=[])) in \
        (None, 0.0)
    # a program without the recorder (the parent of this change)
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert reader(name).read(
        Context(tracer=FakeTracer(0.0, 1.0, [(0.0, 1.0)]),
                traced_rounds=[])) is None


def test_manifest_lists_the_span_metrics():
    entries = {m["name"]: m for m in BENCH["per_layer"]}
    for name in SPAN_METRICS[:-1]:
        m = entries[name]
        assert m["workloads"] == ["ddim-k32-stack"]
        assert m["source"] == ("device_trace" if name in IDLE
                               else "program_span")
    assert "prefill_ms" not in entries          # the pending cell's


@pytest.fixture(scope="module")
def traced_cpu_rounds():
    """Two rounds of the ddim cell at smoke sizes on the CPU, run through
    the harness under a CPU profiler, the device idle the whole window."""
    from torch.profiler import ProfilerActivity, profile

    from harness.loop import Rounds
    entry, traffic, cfg, ref, drv = load_cell(BENCH, "ddim-k32-stack")
    cfg = dict(cfg, image_size=16, base_channels=32, channel_mults=[1, 2],
               num_res_blocks=1, attn_resolutions=[8], num_groups=8)
    traffic = dict(traffic, K=4, warm_batches=[1, 2, 4],
                   deadline_s=[0.1, 0.3], delay={"a": 0.004, "b": 0.02})
    seed = 2**33 + 11
    driver = drv.Driver(cfg, traffic, ref, seed, "cpu")
    driver.setup()
    rounds = Rounds(driver, traffic)
    obs.take()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        logs = [rounds.run(r, round_requests(traffic, seed, r))
                for r in range(2)]
    t1 = time.perf_counter()
    ctx = Context(tracer=FakeTracer(t0, t1, [(t0, t1 - t0)]),
                  traced_rounds=logs, traffic=traffic)
    yield ctx, obs.spans()
    obs.take()


def test_cpu_rounds_bucket_fill_is_the_batch_log(traced_cpu_rounds):
    ctx, _ = traced_cpu_rounds
    ids = [b[0] for log in ctx.traced_rounds for b in log.batches]
    assert ids
    want = 100.0 * sum(len(i) for i in ids) / \
        sum(shape_bucket(len(i)) for i in ids)
    assert reader("bucket_fill_pct").read(ctx) == pytest.approx(want,
                                                                abs=1e-9)


def test_cpu_rounds_unclocked_is_round_less_loop_clock(traced_cpu_rounds):
    ctx, spans = traced_cpu_rounds
    rounds = [s for s in spans if s.name == "round"]
    assert len(rounds) == len(ctx.traced_rounds) == 2
    want = []
    for r, log in zip(rounds, ctx.traced_rounds):
        clock = sum(m for _, _, m in log.records)
        want.append(r.t1 - r.t0 - clock)
        # the harness's own span of the round holds the program's
        assert log.t0 <= r.t0 and r.t1 <= log.t1
        assert 0 < want[-1] <= log.t1 - log.t0 - clock
    assert reader("unclocked_ms").read(ctx) == pytest.approx(
        1e3 * sum(want) / 2, rel=1e-9)


def test_cpu_rounds_idle_split_covers_the_window(traced_cpu_rounds):
    from harness.spans import idle_pct_by_layer
    ctx, _ = traced_cpu_rounds
    split = idle_pct_by_layer(ctx)
    assert all(split[k] > 0 for k in ("planner", "engine", "loop",
                                      "harness"))
    assert split["serving"] == split["other"] == 0.0
    assert sum(split.values()) == pytest.approx(100.0, abs=1e-9)
