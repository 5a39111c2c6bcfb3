"""The paper's analytic planning core, in NumPy.

Copies of the parts of ``repro.core`` that the static provisioning path
runs (the port imports nothing of ``repro``): the delay model g(X), the
FID power law, scenarios, the batch-plan IR, STACKING, the P1
allocators and the simulator.  tests/test_torch_core_copy.py holds each
copy's output equal (``==``) to the original's.
"""
