"""The paper's analytic planning core, in NumPy, and its device engine.

Copies of the parts of ``repro.core`` that the port's paths run (the
port imports nothing of ``repro``): the delay model g(X), the FID power
law, scenarios, the batch-plan IR, STACKING with its engine registry and
vec engine (``arrays``), the baselines, the offset-native replanner, the
exact DP, the P1 allocators, the simulator, the closed loop, and the
many-server layer: arrival processes (``traffic``), placement over
edge cells (``multiserver``) and the population-scale fleet (``fleet``).
tests/test_torch_core_copy.py, tests/test_torch_planner.py and the
traffic, multiserver and fleet tests hold each copy's output equal
(``==``) to the original's.  ``torchplan`` is the
counterpart of ``repro.core.jaxplan``: the planner's sweeps in torch,
float64, on the card (``engine="torch"``).
"""
