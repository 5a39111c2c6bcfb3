"""Declarative parameter schemas, in PyTorch.

A schema is a nested dict/list whose leaves are ``P(shape, init=...)``.
The port's counterpart of ``repro.models.params`` (which imports jax at
the top, so the port keeps its own leaf and schema walk).  From one
schema we derive

  * ``init_params``       -- random tensors from a ``torch.Generator``
  * ``params_from_numpy`` -- the reference's param tree (numpy arrays)
                             as the port's tensors, shape-checked
  * ``opt_state_from_numpy`` -- the reference's AdamW state the same way

Convolution leaves are stored OIHW, the layout ``F.conv2d`` takes; the
reference stores them HWIO, and ``params_from_numpy`` transposes them.
Every other leaf keeps the reference's layout: the transformer's
``wq (d,H,hd)``, ``wo (H,hd,d)``, ``up``/``gate (d,f)`` and ``head
(d,V)``, stacked ``(L, ...)`` over layers, arrive as they are, with no
transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf.  ``conv`` marks an OIHW convolution weight
    (HWIO in the reference)."""
    shape: Tuple[int, ...]
    init: str = "normal"      # normal | zeros | ones | embed
    scale: Optional[float] = None
    conv: bool = False

    @property
    def fan_in(self) -> int:
        # the reference takes shape[-2] of its HWIO / (in, out) leaves:
        # the input channels, which sit at index 1 of an OIHW weight.
        # Copied as it is for every other leaf, stacked (L, ...) ones
        # included: it gives wq (d,H,hd) a fan_in of H.
        if self.conv:
            return self.shape[1]
        return self.shape[-2] if len(self.shape) >= 2 else self.shape[-1]


def map_schema(fn, schema, path: str = ""):
    """Apply ``fn(leaf, path)`` to every ``P`` leaf, keeping the
    nesting; ``path`` names the leaf ("downs/0/res/0/res/conv1")."""
    if isinstance(schema, P):
        return fn(schema, path)
    if isinstance(schema, dict):
        return {k: map_schema(fn, v, f"{path}/{k}") for k, v in schema.items()}
    if isinstance(schema, (list, tuple)):
        return [map_schema(fn, v, f"{path}/{i}") for i, v in enumerate(schema)]
    raise TypeError(f"{path or '/'}: unexpected schema node {type(schema)}")


def init_params(schema, generator: torch.Generator, device,
                dtype: torch.dtype = torch.float32):
    """Random params: normal(0, 1/sqrt(fan_in)) unless the leaf pins a
    scale, normal(0, scale or 0.02) for ``embed`` leaves, ones/zeros
    where the leaf says so.  Drawn on the generator's device, then moved
    to ``device``."""
    def make(p: P, _path):
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        if p.init == "embed":
            scale = p.scale or 0.02
        elif p.scale is not None:
            scale = p.scale
        else:
            scale = 1.0 / np.sqrt(max(p.fan_in, 1))
        w = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * scale
        return w.to(device=device, dtype=dtype)

    return map_schema(make, schema)


def params_from_numpy(schema, tree, device,
                      dtype: torch.dtype = torch.float32):
    """The reference's param tree (leaves convertible with
    ``np.asarray``) as the port's tensors on ``device``.  Convolution
    weights go HWIO -> OIHW.  Raises on a missing or extra key, a list
    of the wrong length or a leaf whose shape disagrees with the
    schema."""
    def convert(s, t, path):
        if isinstance(s, P):
            a = np.asarray(t, dtype=np.float32)
            if s.conv:
                if a.ndim != 4:
                    raise ValueError(f"{path}: conv leaf has shape {a.shape}")
                a = a.transpose(3, 2, 0, 1)
            if tuple(a.shape) != tuple(s.shape):
                raise ValueError(f"{path}: shape {tuple(a.shape)} does not "
                                 f"match the schema's {tuple(s.shape)}")
            return torch.tensor(a, dtype=dtype, device=device)
        if isinstance(s, dict):
            if not isinstance(t, dict):
                raise TypeError(f"{path or '/'}: expected a dict")
            missing, extra = set(s) - set(t), set(t) - set(s)
            if missing or extra:
                raise KeyError(f"{path or '/'}: missing {sorted(missing)}, "
                               f"extra {sorted(extra)}")
            return {k: convert(s[k], t[k], f"{path}/{k}") for k in s}
        if not isinstance(t, (list, tuple)) or len(t) != len(s):
            raise ValueError(f"{path or '/'}: expected a list of {len(s)}")
        return [convert(a, b, f"{path}/{i}")
                for i, (a, b) in enumerate(zip(s, t))]

    return convert(schema, tree, "")


def opt_state_from_numpy(schema, state, device):
    """The reference's AdamW state ``{"step", "m", "v"}`` (leaves
    convertible with ``np.asarray``) as the port's: ``step`` an int32
    scalar tensor, ``m`` and ``v`` float32 trees converted as
    ``params_from_numpy`` converts params, so a JAX run resumes in the
    port."""
    return {"step": torch.tensor(np.asarray(state["step"]),
                                 dtype=torch.int32, device=device),
            "m": params_from_numpy(schema, state["m"], device),
            "v": params_from_numpy(schema, state["v"], device)}
