"""The manifest and the files the harness finds by name."""

import json
import re
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(PB))

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
PENDING = json.loads((PB / "pending.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_found(conf):
    path = ROOT / conf["file"]
    cfg = json.loads(path.read_text())
    assert cfg["name"] == conf["name"]
    assert cfg["source"] == conf["source"]
    assert (ROOT / cfg["reference"]).is_file()
    assert (PB / "drivers" / f"{cfg['driver']}.py").is_file()
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found(cell):
    traffic = json.loads(
        (PB / "workloads" / f"{cell['traffic']}.json").read_text())
    assert cell["chips"] in (1, 4)
    assert {"K", "deadline_s", "allocator", "scheduler", "limits",
            "check"} <= set(traffic)
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    layer = [m["name"] for m in BENCH["per_layer"]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_readers_found(metric):
    from harness.bench import load_module
    mod = load_module(PB / "metrics" / f"{metric['name']}.py", "m")
    assert callable(mod.read)
    if metric in BENCH["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        cells = [w["name"] for w in BENCH["workloads"]]
        assert set(metric.get("workloads", cells)) <= set(cells)


def test_layers_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "kernels" in layers and "device" in layers
    rooflines = [m["name"] for m in BENCH["per_layer"]
                 if m["name"].endswith("_roofline")]
    assert all(m["unit"] == "%" for m in BENCH["per_layer"]
               if m["name"] in rooflines or "mfu" in m["name"])


@pytest.mark.parametrize("entry", PENDING["configs"] + PENDING["workloads"]
                         + PENDING["per_layer"], ids=lambda e: e["name"])
def test_pending_entries_found(entry):
    """A pending cell's entries are whole and its files are there, so a
    change adds it by copying the entries into the manifest."""
    test_names_and_units(entry)
    if "file" in entry:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        assert cfg["name"] == entry["name"]
        assert (ROOT / cfg["reference"]).is_file()
        assert (PB / "drivers" / f"{cfg['driver']}.py").is_file()
    elif "traffic" in entry:
        assert (PB / "workloads" / f"{entry['traffic']}.json").is_file()
        assert entry["config"] in [c["name"] for c in PENDING["configs"]]
    else:
        from harness.bench import load_module
        mod = load_module(PB / "metrics" / f"{entry['name']}.py", "m")
        assert callable(mod.read)
        assert entry["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        assert entry["workloads"] == [w["name"]
                                      for w in PENDING["workloads"]]
