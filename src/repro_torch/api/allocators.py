"""Allocator registry entries: uniform adapters over the P1 solvers in
``repro_torch.core.bandwidth``.

Every entry has the ``Allocator`` signature
``(scenario, scheduler, delay, quality, **kwargs) -> np.ndarray``; the
closed-form splits ignore the scheduler and models, and the search-based
ones pass ``**kwargs`` through (``num_particles``, ``iters``, ``seed``,
...).  The port of ``repro.api.allocators``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.api.registry import get_allocator, register_allocator
from repro_torch.core.bandwidth import (coordinate_refine, equal_allocate,
                                        inv_se_allocate, pso_allocate)
from repro_torch.core.delay_model import DelayModel
from repro_torch.core.quality_model import QualityModel
from repro_torch.core.service import Scenario


@register_allocator("equal")
def equal(scn: Scenario, scheduler=None, delay: DelayModel = None,
          quality: QualityModel = None, **_) -> np.ndarray:
    return equal_allocate(scn)


@register_allocator("inv_se")
def inv_se(scn: Scenario, scheduler=None, delay: DelayModel = None,
           quality: QualityModel = None, **_) -> np.ndarray:
    return inv_se_allocate(scn)


@register_allocator("pso")
def pso(scn: Scenario, scheduler, delay: DelayModel,
        quality: QualityModel, *, seed: int = 0, **kw) -> np.ndarray:
    # seed is explicit so a facade's seed= finds it by signature
    return pso_allocate(scn, scheduler, delay, quality, seed=seed,
                        **kw).alloc


@register_allocator("coordinate")
def coordinate(scn: Scenario, scheduler, delay: DelayModel,
               quality: QualityModel, *, init: str = "inv_se",
               **kw) -> np.ndarray:
    """Hill-climb refinement of a closed-form split (``init``: any
    registered allocator name, default ``inv_se``)."""
    start = get_allocator(init)(scn, scheduler, delay, quality)
    return coordinate_refine(scn, start, scheduler, delay, quality,
                             **kw).alloc
