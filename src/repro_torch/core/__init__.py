"""The paper's analytic planning core, in NumPy, and its device engine.

Copies of the parts of ``repro.core`` that the port's paths run (the
port imports nothing of ``repro``): the delay model g(X), the FID power
law, scenarios, the batch-plan IR, STACKING with its engine registry and
vec engine (``arrays``), the baselines, the offset-native replanner, the
exact DP, the P1 allocators, the simulator and the closed loop.
tests/test_torch_core_copy.py and tests/test_torch_planner.py hold each
copy's output equal (``==``) to the original's.  ``torchplan`` is the
counterpart of ``repro.core.jaxplan``: the planner's sweeps in torch,
float64, on the card (``engine="torch"``).
"""
