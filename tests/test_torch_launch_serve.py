"""The port's serving launcher (``repro_torch.launch.serve``) on the
CPU: at ``--smoke --device cpu --requests 3`` with a fixed delay model
in place of the calibration, its STACKING plan (tokens per request) and
both mean quality penalties are ``==`` to what the port's NumPy
``core.stacking`` and ``core.baselines.greedy_batching`` give on the same
deadlines, every request gets its planned tokens, and ``--device cuda``
raises without a card.  No jax here: the launcher's plan is held to the
port's planning core, which tests/test_torch_planner.py holds ``==`` to
the reference's."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.baselines import greedy_batching  # noqa: E402
from repro_torch.core.delay_model import DelayModel  # noqa: E402
from repro_torch.core.service import ServiceRequest  # noqa: E402
from repro_torch.core.stacking import stacking  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving.engine import TokenQuality  # noqa: E402

G = DelayModel(a=0.004, b=0.03)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-moe-16b",
                                  "qwen3-moe-30b-a3b", "codeqwen1.5-7b",
                                  "minitron-4b", "granite-34b"])
def test_launcher_plan_and_penalties_match_the_numpy_core(arch):
    lines = []
    rep = serve.serve(["--arch", arch, "--smoke", "--device", "cpu",
                       "--requests", "3"], delay=G, echo=lines.append)
    deadlines = rep["deadlines"]
    assert len(deadlines) == 3 and deadlines == sorted(deadlines)
    svcs = [ServiceRequest(id=i, deadline=d, spectral_eff=1.0)
            for i, d in enumerate(deadlines)]
    tp = {s.id: s.deadline for s in svcs}
    q = TokenQuality()
    plan = stacking(svcs, tp, G, q)
    greedy = greedy_batching(svcs, tp, G)
    assert rep["delay"] == (G.a, G.b)
    assert rep["steps"] == plan.steps_completed
    assert rep["batches"] == plan.num_batches
    assert rep["quality_stacking"] == q.mean_fid(
        list(plan.steps_completed.values()))
    assert rep["quality_greedy"] == q.mean_fid(
        list(greedy.steps_completed.values()))
    assert rep["quality_stacking"] <= rep["quality_greedy"]
    for rid, toks in rep["tokens"].items():
        assert len(toks) == plan.steps_completed[rid] > 0
    assert any(line.startswith("\nmean quality penalty: stacking=")
               for line in lines)
    assert rep["arch"].endswith("-smoke") and rep["device"] == "cpu"


def test_launcher_cuts_depth_with_layers():
    """--layers keeps the first N layers at full width (granite-34b runs
    on one card at 44 of its 88); here on the smoke variant's 2."""
    lines = []
    rep = serve.serve(["--arch", "granite-34b", "--smoke", "--layers", "1",
                       "--device", "cpu", "--requests", "2"], delay=G,
                      echo=lines.append)
    assert lines[0].startswith("arch=granite-34b-smoke layers=1 ")
    assert sorted(rep["tokens"]) == [0, 1]


def test_launcher_deadlines_option_and_calibration():
    """--deadlines replaces the random draw; without ``delay`` the
    launcher calibrates g(X) on the device."""
    rep = serve.serve(["--smoke", "--device", "cpu", "--deadlines",
                       "0.05,0.1"], echo=lambda _: None)
    assert rep["deadlines"] == [0.05, 0.1]
    assert sorted(rep["tokens"]) == [0, 1]
    assert all(len(rep["tokens"][k]) == rep["steps"][k] for k in (0, 1))


def test_launcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        serve.serve(["--smoke", "--device", "cuda"], delay=G,
                    echo=lambda _: None)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke"])
