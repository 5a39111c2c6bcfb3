"""Whole runs of the harness on the CPU at smoke sizes (the look for a
card skipped), sound and with the timed path broken underneath: each
fault a cell can have must turn ``correct`` false."""

import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(PB))

from harness.bench import load_cell, metrics_of, run_driver  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
PENDING = json.loads((PB / "pending.json").read_text())
# the manifest with the pending cells' entries beside its own
BENCH_ALL = dict(BENCH, **{
    k: BENCH[k] + [e for e in PENDING[k]
                   if e["name"] not in {x["name"] for x in BENCH[k]}]
    for k in ("configs", "workloads", "per_layer")})
SMOKE = {
    "ddim-k32-stack": {
        "config": {"image_size": 16, "base_channels": 32,
                   "channel_mults": [1, 2], "num_res_blocks": 1,
                   "attn_resolutions": [8], "num_groups": 8},
        "traffic": {"K": 4, "warm_batches": [1, 2, 4],
                    "deadline_s": [0.1, 0.3],
                    "delay": {"a": 0.004, "b": 0.02},
                    "check": {"first_plans": 2, "replans": 2,
                              "images": 8}}},
    "dsmoe-k8-decode": {
        "config": {"hidden_size": 128, "num_attention_heads": 2,
                   "num_key_value_heads": 2, "num_hidden_layers": 2,
                   "moe_intermediate_size": 32, "n_routed_experts": 8,
                   "num_experts_per_tok": 2, "n_shared_experts": 1,
                   "vocab_size": 256, "initializer_range": 0.2},
        "traffic": {"K": 4, "prompt_len": 16, "deadline_s": [0.2, 0.6],
                    "total_bandwidth_hz": 1.6e6,
                    "warm_batches": [1, 2, 4],
                    "check": {"first_plans": 2, "replans": 2,
                              "requests": 8}}},
}


CONTENT = {"ddim-k32-stack": "image_err",
           "dsmoe-k8-decode": "mismatch_share"}


def _run(cell, seed=2**33 + 5, seconds=1.5):
    entry, traffic, cfg, ref, drv = load_cell(BENCH_ALL, cell)
    driver = drv.Driver(dict(cfg, **SMOKE[cell]["config"]),
                        dict(traffic, **SMOKE[cell]["traffic"]), ref, seed,
                        "cpu")
    # few threads, so that parallel test workers do not oversubscribe
    # the cores and stretch a round past the window
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = run_driver(BENCH_ALL, entry, driver, seconds, False,
                         time.perf_counter())
    finally:
        torch.set_num_threads(threads)
    assert CONTENT[cell] in res["checks"], res
    return res, drv, driver


@pytest.mark.parametrize("cell", list(SMOKE))
def test_sound_run_is_correct(cell):
    # a window long enough for two rounds on a loaded CPU
    res, drv, driver = _run(cell, seconds=4.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 8
    assert set(res["metrics"]) == {
        m["name"] for m in metrics_of(BENCH_ALL, cell, False)}
    # the control reads the same number over what the check compared
    # (on the CPU TF32 changes nothing; the card's test judges it)
    assert drv.control(driver)[CONTENT[cell]] >= 0.0


ARMED = {"on": False}


def _armed(broken, sound):
    """``broken`` once the first round starts (set-up runs sound, so
    the warm-up steps run the real step), ``sound`` before."""
    def call(*a, **kw):
        return (broken if ARMED["on"] else sound)(*a, **kw)
    return call


def _unchanged_step(mp):
    from repro_torch.diffusion.executor import BatchDenoisingExecutor
    step = BatchDenoisingExecutor.step_fn

    def unchanged(self, x, t_now, t_next):
        step(self, x, t_now, t_next)     # the step's work, its result lost
        return x
    mp.setattr(BatchDenoisingExecutor, "step_fn", _armed(unchanged, step))


def _half_batch(mp):
    from repro_torch.diffusion.bucketed import BucketedDenoiseSession
    lanes = BucketedDenoiseSession._lanes

    def half(self, ks):
        idx, t_now, t_next = lanes(self, ks)
        t_now[len(ks) // 2:len(ks)] = -1  # these rows pass through
        return idx, t_now, t_next
    mp.setattr(BucketedDenoiseSession, "_lanes", _armed(half, lanes))


def _image_altered(mp):
    from repro_torch.diffusion.bucketed import BucketedDenoiseSession
    finish = BucketedDenoiseSession.finish
    mp.setattr(BucketedDenoiseSession, "finish", _armed(lambda self: {
        k: v * np.float32(1.001) for k, v in finish(self).items()}, finish))


def _token_altered(mp):
    from repro_torch.serving.engine import ServingEngine
    step = ServingEngine.step_batch

    def altered(self, rids, timed=False):
        dt = step(self, rids, timed)
        req = self.requests[rids[0]]
        req.generated[-1] = (req.generated[-1] + 1) % self.cfg.vocab_size
        return dt
    mp.setattr(ServingEngine, "step_batch", _armed(altered, step))


def _decode_state_unchanged(mp):
    from repro_torch.models import transformer
    step = transformer.decode_step

    def stale(cfg, params, token, cache, run, extras=None):
        logits, _ = step(cfg, params, token, cache, run, extras)
        return logits, cache
    mp.setattr(transformer, "decode_step", _armed(stale, step))


@pytest.mark.parametrize("cell,fault", [
    ("ddim-k32-stack", _unchanged_step),
    ("ddim-k32-stack", _half_batch),
    ("ddim-k32-stack", _image_altered),
    ("dsmoe-k8-decode", _token_altered),
    ("dsmoe-k8-decode", _decode_state_unchanged),
], ids=lambda f: getattr(f, "__name__", f))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    from harness import loop
    run = loop.Rounds.run

    def arming(self, r, requests):
        ARMED["on"] = True
        return run(self, r, requests)
    fault(monkeypatch)
    monkeypatch.setattr(loop.Rounds, "run", arming)
    monkeypatch.setitem(ARMED, "on", False)
    res, _, _ = _run(cell)
    assert not res["correct"], res["checks"]
