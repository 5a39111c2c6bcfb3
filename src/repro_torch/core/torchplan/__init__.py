"""``repro_torch.core.torchplan`` — the "torch" planner engine, the
counterpart of ``repro.core.jaxplan``.

Importing this package registers ``engine="torch"`` with
``repro_torch.core.arrays``' engine registry; the existing dispatch
(``set_engine`` / ``engine_scope`` / per-call ``engine=`` kwargs /
``REPRO_PLANNER_ENGINE=torch``) then routes the planner entry points
here.  ``arrays`` probes this package on the first request for an
engine it does not know.

The engine runs on the card.  ``with device_scope("cpu"):`` asks for
the CPU, around any call; ``Provisioner(device=...)`` sets the scope
around its planning.  Without a card and without that request it
raises: it never carries on on the CPU.

Layout:

* ``kernels``  — the ``(L, K)`` sweeps (host loops over batch rounds,
  every candidate level and scenario advancing together on the device)
  plus scoring and selection.
* ``backend``  — the engine entry points (``stacking``,
  ``equal_steps``, ``offset_plan``) the vec/scalar dispatch sites call
  through ``arrays.engine_impl("torch")``.
* ``batched``  — ``plan_many`` / ``replan_many``: the whole T* search
  over ~10^3 stacked scenarios in one call.
* ``sharded``  — the same with the scenario axis split across devices
  (``plan_many_sharded``, ``replan_many_sharded``; ``devices=`` of the
  batched calls routes there).
* ``optimal``  — the exact DP as a breadth-first sweep.

Equivalence contract: objectives match the NumPy engines within 1e-9
mean FID, never bit for bit (sums may run in another order and CUDA's
float64 ``pow`` may differ from libm in the last ulp).  Returned
``BatchPlan``s are always materialized by the exact NumPy single-level
passes, so they satisfy the paper's constraints whatever the engine.
The sharded calls are ``==`` to the unsharded ones.
"""

from __future__ import annotations

import types

from repro_torch.core import arrays as _arrays
from repro_torch.core.torchplan import (backend, batched, kernels, optimal,
                                        sharded)
from repro_torch.core.torchplan.backend import (equal_steps, offset_plan,
                                                stacking)
from repro_torch.core.torchplan.batched import (PlanManyResult, plan_many,
                                                replan_many)
from repro_torch.core.torchplan.kernels import device_scope
from repro_torch.core.torchplan.optimal import (optimal_mean_fid,
                                                optimal_plan)
from repro_torch.core.torchplan.sharded import (plan_many_sharded,
                                                replan_many_sharded,
                                                resolve_devices)

#: what ``arrays.engine_impl("torch")`` hands to the dispatch sites
IMPL = types.SimpleNamespace(
    name="torch",
    stacking=stacking,
    equal_steps=equal_steps,
    offset_plan=offset_plan,
    optimal_plan=optimal_plan,
    optimal_mean_fid=optimal_mean_fid,
    plan_many=plan_many,
    replan_many=replan_many,
)

_arrays.register_engine("torch", IMPL)

__all__ = [
    "IMPL",
    "PlanManyResult",
    "backend",
    "batched",
    "device_scope",
    "equal_steps",
    "kernels",
    "offset_plan",
    "optimal",
    "optimal_mean_fid",
    "optimal_plan",
    "plan_many",
    "plan_many_sharded",
    "replan_many",
    "replan_many_sharded",
    "resolve_devices",
    "sharded",
    "stacking",
]
