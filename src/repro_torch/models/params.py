"""Declarative parameter schemas, in PyTorch.

A schema is a nested dict/list whose leaves are ``P(shape,
logical_axes, init=...)``.  The port's counterpart of
``repro.models.params`` (which imports jax at the top, so the port keeps
its own leaf and schema walk).  From one schema we derive

  * ``init_params``       -- random tensors from a ``torch.Generator``
  * ``params_from_numpy`` -- the reference's param tree (numpy arrays)
                             as the port's tensors, shape-checked
  * ``opt_state_from_numpy`` -- the reference's AdamW state the same way
  * ``param_pspecs``      -- the matching ``PS`` tree from sharding rules

Logical axes resolve against ``repro_torch.config.sharding_rules_for``.
A ``PS`` is the port's partition spec (the reference's ``PartitionSpec``,
read as a tuple): one entry per tensor dim, each None, a mesh-axis name
or a tuple of names.  On a ``torch.distributed`` device mesh it becomes
DTensor placements (``placements``): ``Shard(d)`` on each mesh axis that
names dim d, ``Replicate()`` on the others.

Models call ``constrain(x, ("batch", "seq", ...))`` where the reference
does; under ``use_rules`` a DTensor is redistributed to the placements
those axes give (the reference's ``with_sharding_constraint``), and a
plain tensor is returned as it is.  ``local_call`` runs a function of
plain tensors (a kernel's wrapper, a per-row step) on each rank's local
shards through ``torch.distributed.tensor.experimental.local_map``.

Convolution leaves are stored OIHW, the layout ``F.conv2d`` takes; the
reference stores them HWIO, and ``params_from_numpy`` transposes them.
Every other leaf keeps the reference's layout: the transformer's
``wq (d,H,hd)``, ``wo (H,hd,d)``, ``up``/``gate (d,f)`` and ``head
(d,V)``, stacked ``(L, ...)`` over layers, arrive as they are, with no
transpose.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    """A parameter leaf: shape + logical axis names (same length).
    ``conv`` marks an OIHW convolution weight (HWIO in the reference;
    its axes, all None, stay in the port's order)."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | embed
    scale: Optional[float] = None
    conv: bool = False

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

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
    where the leaf says so.  Drawn in float32 on the generator's device
    and scaled in place, then moved to ``device`` and cast where either
    differs, so drawing a leaf holds one float32 copy of it (init's peak
    is the sum of the leaves when the generator is on ``device``)."""
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
                        device=generator.device).mul_(scale)
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


# ---------------------------------------------------------------------------
# Partition specs from the logical axes
# ---------------------------------------------------------------------------

class PS(tuple):
    """A partition spec: ``PS("data", None, ("pod", "model"))``, one entry
    per tensor dim (fewer: the rest replicated)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PS{tuple.__repr__(self)}"


def axis_part(rules: dict, ax):
    """The mesh axes of logical axis ``ax`` under ``rules``, as a spec
    entry: None, one name, or a tuple of names."""
    m = rules.get(ax) if ax is not None else None
    if m is None:
        return None
    if isinstance(m, (tuple, list)):
        return m[0] if len(m) == 1 else tuple(m)
    return m


def _names(part) -> tuple:
    return (part,) if isinstance(part, str) else tuple(part or ())


def _dedup(parts: list, order) -> list:
    """Keep each mesh axis in one entry only, the first met in ``order``
    (indices into ``parts``); a later entry that names a used axis
    becomes None."""
    used = set()
    for i in order:
        if any(n in used for n in _names(parts[i])):
            parts[i] = None
        else:
            used.update(_names(parts[i]))
    return parts


def spec_of(axes, rules: dict, last_wins: bool = True) -> PS:
    """The ``PS`` of logical ``axes`` under ``rules``.  A mesh axis may
    name one dim only: for activations (``constrain``) the LAST logical
    axis that maps to it wins, as the reference's Megatron-style rule;
    for weights (``param_pspecs``) the FIRST."""
    parts = [axis_part(rules, ax) for ax in axes]
    order = range(len(parts) - 1, -1, -1) if last_wins else range(len(parts))
    return PS(*_dedup(parts, order))


def param_pspecs(schema, rules: dict):
    """The ``PS`` of every leaf: for weights the FIRST occurrence of a mesh
    axis wins (e.g. MoE (experts, embed, mlp): expert parallelism
    outranks the inner mlp split on the same axis)."""
    return map_schema(lambda p, _path: spec_of(p.axes, rules, False), schema)


# ---------------------------------------------------------------------------
# Activation sharding: models call ``constrain(x, ("batch", "seq", ...))``
# and the launch layer installs the rules with ``use_rules``.
# ---------------------------------------------------------------------------

_ACTIVE_RULES: Optional[dict] = None


class use_rules:
    """Context manager installing logical->mesh rules for ``constrain``."""

    def __init__(self, rules: Optional[dict]):
        self.rules = rules

    def __enter__(self):
        global _ACTIVE_RULES
        self._prev = _ACTIVE_RULES
        _ACTIVE_RULES = self.rules
        return self

    def __exit__(self, *exc):
        global _ACTIVE_RULES
        _ACTIVE_RULES = self._prev
        return False


def active_rules() -> Optional[dict]:
    """The rules ``use_rules`` installed, or None."""
    return _ACTIVE_RULES


def rule_active(name: str) -> bool:
    """True when the installed rules map this logical axis to a mesh axis."""
    return bool(_ACTIVE_RULES) and _ACTIVE_RULES.get(name) is not None


def is_dtensor(x) -> bool:
    """True for a DTensor.  Reads ``torch.distributed.tensor`` only once
    something imported it (no DTensor exists before), so the unsharded
    path never pays for its import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` (a ``PS``) on ``mesh``, one per mesh
    dim: ``Shard(d)`` where entry d names the mesh dim (a dim named by
    two mesh axes is sharded on both, in mesh order), ``Replicate()``
    elsewhere.  Mesh axes that the mesh lacks are ignored."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, part in enumerate(spec) if name in _names(part)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def constrain(x, axes: Tuple[Optional[str], ...]):
    """Redistribute a DTensor to the placements of logical ``axes`` under
    the installed rules (the LAST logical axis mapping to a mesh axis
    wins); a no-op without rules or on a plain tensor, as the reference
    is outside a mesh."""
    if _ACTIVE_RULES is None or not is_dtensor(x):
        return x
    want = placements(x.device_mesh, spec_of(axes, _ACTIVE_RULES))
    if tuple(x.placements) == want:
        return x
    return redistribute(x, want)


def redistribute(x, pl):
    """``x.redistribute`` to placements ``pl``, with a contiguous local
    block (``dense``): where the process group has no all-to-all (gloo),
    DTensor gathers and keeps a strided chunk."""
    return dense(x.redistribute(x.device_mesh, tuple(pl)))


def dense(x):
    """x laid out contiguously: for a DTensor, its local block too (a
    DTensor's ``contiguous()`` may leave a strided local block, which
    the view rules after it reject)."""
    if not is_dtensor(x):
        return x.contiguous()
    local = x.to_local()
    if local.is_contiguous() and x.is_contiguous():
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local.contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape,
                                                 device="meta").stride())


def _settled(x):
    """x with every Partial placement reduced to Replicate (a local
    function must read whole values)."""
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return redistribute(x, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def local_call(fn, out_placements, *args):
    """``fn(*args)`` on each rank's local shards of the DTensors among
    ``args`` (nested lists, tuples and dicts too), through ``local_map``:
    its outputs become DTensors with ``out_placements`` (one placements
    tuple, or a tuple of them for several outputs).  Every DTensor is
    passed with its own placements, Partial ones reduced first; the
    caller puts them where ``fn``'s local arithmetic is right.  A
    Partial in ``out_placements`` (an input's placements, read before
    that reduction) means Replicate.

    The gradient of an input replicated on a mesh dim along which an
    output is sharded is Partial there: each rank's shard of the output
    adds its part (a norm's scale over the rank's rows, a replicated KV
    head read by the rank's query heads)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from torch.utils import _pytree as pytree

    flat, spec = pytree.tree_flatten(args)
    flat = [_settled(a) if is_dtensor(a) else a for a in flat]
    mesh = next(a.device_mesh for a in flat if is_dtensor(a))
    outs = out_placements if isinstance(out_placements[0], (tuple, list)) \
        else (out_placements,)
    outs = tuple(tuple(Replicate() if isinstance(p, Partial) else p
                       for p in o) for o in outs)
    split = [any(isinstance(o[i], Shard) for o in outs)
             for i in range(mesh.ndim)]
    in_pl = tuple(tuple(a.placements) if is_dtensor(a) else None
                  for a in flat)
    grad_pl = tuple(
        None if pl is None else tuple(
            Partial() if split[i] and not isinstance(p, Shard) else p
            for i, p in enumerate(pl))
        for pl in in_pl)

    def flat_fn(*leaves):
        return fn(*pytree.tree_unflatten(list(leaves), spec))
    # local_map reads a tuple as one placements entry per output and a
    # list as the placements of a single output
    out = tuple(list(o) for o in outs)
    return local_map(flat_fn, out_placements=out if len(out) > 1 else out[0],
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh)(*flat)


def elementwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; on a DTensor, on each rank's
    block (``local_call``), for the ops whose backward DTensor has no
    sharding rule for (``F.logsigmoid``)."""
    if not is_dtensor(x):
        return fn(x)
    return local_call(fn, tuple(x.placements), x)


def mesh_of(tree):
    """The device mesh of the first DTensor leaf of ``tree``, or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            m = mesh_of(t)
            if m is not None:
                return m
        return None
    return tree.device_mesh if is_dtensor(tree) else None


def local_shard(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under placements
    ``pl`` on ``mesh``: a view (no copy) where nothing is split.  Every
    split dim must divide evenly."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            d = p.dim % t.dim()
            if t.shape[d] % n:
                raise ValueError(
                    f"dim {d} of size {t.shape[d]} does not divide over "
                    f"mesh axis {mesh.mesh_dim_names[i]!r} of {n}")
            step = t.shape[d] // n
            t = t.narrow(d, coord[i] * step, step)
    return t


def shard_as(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor ``t`` (the same on every rank) as a DTensor with
    ``spec``'s placements, built from this rank's block of it (no
    collective; no copy where nothing is split).  A DTensor is
    redistributed."""
    pl = placements(mesh, spec)
    if is_dtensor(t):
        return t if tuple(t.placements) == pl else redistribute(t, pl)
    return _from_whole(t, mesh, pl)


def shard_as_placements(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """The whole tensor ``t`` (the same on every rank) as a DTensor with
    placements ``pl`` on ``mesh``, from this rank's block."""
    return _from_whole(t, mesh, tuple(pl))


def shard_like(t: torch.Tensor, like) -> torch.Tensor:
    """The whole tensor ``t`` placed as the DTensor ``like`` (its mesh
    and placements), from this rank's block."""
    return _from_whole(t, like.device_mesh, tuple(like.placements))


def _from_whole(t: torch.Tensor, mesh, pl):
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local_shard(t, mesh, pl).contiguous(), mesh,
                              pl, run_check=False)


def zeros(shape, like, axes, dtype: torch.dtype = torch.float32):
    """Zeros of ``shape`` on ``like``'s device; when ``like`` is a
    DTensor, one on its mesh placed by the logical ``axes`` under the
    installed rules (each rank allocates its block only, on the device
    of ``like``'s block: the meta device in the dry run, whose mesh is
    a CPU one)."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = like.device_mesh
    pl = placements(mesh, spec_of(axes, _ACTIVE_RULES))
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=like.to_local().device),
        mesh, pl, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def shard_batch(params, t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, ...) sharded on ``batch`` over the mesh of ``params``
    under the installed rules (the reference's ``batch_spec``), when the
    params are DTensors; ``t`` itself otherwise.  Sharded params need
    the rules installed (``use_rules``)."""
    mesh = mesh_of(params)
    if mesh is None:
        return t
    if _ACTIVE_RULES is None:
        raise ValueError("the params are DTensors: install the sharding "
                         "rules with repro_torch.models.params.use_rules")
    return shard_as(t, mesh, spec_of(("batch",) + (None,) * (t.dim() - 1),
                                     _ACTIVE_RULES))


def whole_along(x, dim: int):
    """DTensor x with its dim ``dim`` replicated over every mesh axis
    (a plain tensor as it is)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim % x.dim() == dim
               else p for p in x.placements)
    return x if pl == tuple(x.placements) else redistribute(x, pl)


def seq_dims(t) -> list:
    """The mesh dims that split DTensor ``t`` (a (B, S, ...) cache) along
    its sequence axis (dim 1); [] for a plain tensor."""
    if not is_dtensor(t):
        return []
    from torch.distributed.tensor import Shard
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim % t.dim() == 1]


class seq_blocks:
    """The blocks of a cache of S rows split along its sequence axis on
    mesh dims ``dims`` of ``mesh``: this rank holds rows [offset, offset
    + S // n) of the n blocks, in the mesh's order (a Python int from
    the mesh coordinate, no read of device data), and ``reduce``
    all-reduces a local tensor over the ranks that hold the others."""

    @staticmethod
    def ways(mesh, dims) -> int:
        """The number of blocks mesh dims ``dims`` split an axis into."""
        return math.prod(mesh.size(i) for i in dims)

    def __init__(self, mesh, dims, S: int):
        coord, idx, n = mesh.get_coordinate(), 0, 1
        for i in dims:
            idx, n = idx * mesh.size(i) + coord[i], n * mesh.size(i)
        if S % n:
            raise ValueError(f"a cache of {S} rows does not split into "
                             f"{n} equal blocks along its sequence axis")
        self.mesh, self.dims, self.offset = mesh, dims, idx * (S // n)

    def reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        from torch.distributed import _functional_collectives as funcol
        for i in self.dims:
            t = funcol.all_reduce(t, op, (self.mesh, i))
        return t

    def combine(self, o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """Every rank's block output o (B,1,H,D) and lse (B,H), float32,
        merged into the output over the whole cache (``ref.lse_combine``
        across ranks): the max of lse, then one sum of the weighted
        outputs and their weights.  A row with no valid position in any
        block gives 0."""
        B, _, H, D = o.shape
        m = self.reduce(lse, "max")
        w = torch.exp(lse - torch.where(torch.isfinite(m), m, 0.0))
        both = self.reduce(torch.cat(
            [(o.reshape(B, H, D) * w[..., None]).reshape(B, H * D), w],
            dim=1), "sum")
        return (both[:, :H * D].reshape(B, 1, H, D)
                / both[:, H * D:].clamp(min=1e-30)[:, None, :, None])
