"""The run command refuses to run without a card, and the import guard
compares whole top-level module names."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
ROOT = PB.parent
sys.path.insert(0, str(PB))

import run  # noqa: E402


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.api", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.service"], ["repro"]),
    (["jax_utils", "jaxtyping", "flaxen"], []),
    (["jax"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen", "jax.numpy"], ["flax", "jax"]),
])
def test_forbidden_by_whole_top_level_name(names, found):
    assert run.forbidden_loaded(names) == found


def test_harness_and_port_load_no_forbidden_module():
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import harness.bench, harness.trace, run; "
            "import repro_torch.api; "
            "print(run.forbidden_loaded())" % (str(PB), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "ddim-k32-stack",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "no CUDA device" in out.stderr
