"""Cost of one step traced on the meta device: the port's counterpart of
``repro.launch.hlo_cost``.

The reference compiles a step for the TPU and walks the optimized HLO;
the port runs eager, one op at a time, so ``TraceCost`` (a
``TorchDispatchMode``) counts the ops a step dispatches while it runs
on meta tensors (shapes and types, no storage, no arithmetic).  Each
count answers one rule of ``hlo_cost``:

  * flops -- products and convolutions only, as ``hlo_cost`` counts dot
    and convolution: ``torch.utils.flop_counter``'s formulas for mm,
    addmm, bmm, baddbmm and the convolutions (einsum and matmul reach
    them as bmm and mm), by the products' type.  Each op counts every
    time it runs, so a Python loop over L layers counts L times: what
    ``hlo_cost`` gets by multiplying a while body by its trip count.
  * bytes -- each op's tensor inputs read and outputs written.  Eager
    PyTorch writes every op's output to memory, so the op is the
    boundary that ``hlo_cost`` draws at a fusion.  Views, reshapes and
    ops that only make a tensor (zeros, empty_like, arange) move
    nothing, as ``_FREE_OPS`` (bitcast, reshape, broadcast, iota,
    constant).  An in-place scatter into a buffer (``index_put_``,
    ``index_copy_``, ``scatter_``: the KV cache writes of
    ``models/kv_cache.py``) counts its indices and values read and the
    values written, not the buffer: the dynamic-update-slice rule (2 x
    the update).  A gather (``index``, ``index_select``, ``gather``,
    ``embedding``) counts its indices and twice its output, the
    dynamic-slice rule.  An in-place op counts its written tensor as
    written (and read, but for copy_, fill_ and zero_).
  * kernel calls -- while a kernel wrapper's meta branch runs
    (``kernels.meta_call``) one call of that kernel is recorded with its
    ``cost(...)``, and none of the ops it makes its outputs with count
    (their memory does).  A backward through ``kernels.plain_backward``
    counts op by op: on the card it is the plain version's autograd.
  * peak live bytes -- the highest sum of the storages the step made
    that are alive at once (its outputs among them, its arguments not).
    A storage is counted when an op's output has one that none of the
    op's inputs has, and weakly referenced; the reference's callback
    takes it off when it dies (``torch`` keeps one Python object per
    storage while the storage lives), so the sum stays exact at a cost
    linear in the number of ops.

  * collectives -- the ``_c10d_functional`` collectives (and DTensor's
    all-to-all, ``_dtensor.shard_dim_alltoall``) by operand bytes and
    calls, under the reference's five names (``COLLECTIVES``; another
    collective under its own op name), and by the group they run over
    (``groups``: group name -> mesh axis, the rest "other").
    ``wait_tensor`` and ``_wrap_tensor_autograd`` move nothing.  Their
    bytes are not HBM bytes: the caller prices them at a link's rate.

On DTensors (a step traced over a device mesh, ``launch.dryrun``) the
counter sees each DTensor op and hands it on (``NotImplemented``), so
what it counts is what DTensor runs on this rank: the local ops on the
rank's blocks and the collectives it inserts, each once.  The ops that
DTensor's sharding propagation runs on fake tensors count nothing.

Times are the H100 SXM data sheet's (``repro_torch.kernels``): products
in bfloat16 at BF16_OPS_PER_S, in float32 at F32_OPS_PER_S (TF32 is off
on the port's paths), each kernel at its own ``cost`` rate; bytes at
HBM_BYTES_PER_S.
"""

from __future__ import annotations

import collections
import sys
import weakref

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode, _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                 HBM_BYTES_PER_S, TRACE, nbytes)

aten = torch.ops.aten

PRODUCTS = (aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
            aten._convolution, aten.convolution_backward)
SCATTERS = (aten.index_put_, aten._index_put_impl_, aten.index_copy_,
            aten.scatter_, aten.scatter_add_, aten.scatter_reduce_,
            aten.index_add_)
GATHERS = (aten.index, aten.index_select, aten.gather, aten.embedding)
OVERWRITES = (aten.copy_, aten.fill_, aten.zero_)
MAKERS = (aten.empty_like, aten.zeros_like, aten.ones_like, aten.full_like,
          aten.new_empty, aten.new_zeros, aten.new_ones, aten.new_full,
          aten.new_empty_strided)
# collective ops (their packet's name) -> the reference's names
# (``repro.launch.dryrun.COLLECTIVE_OPS``)
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all"}
COLLECTIVE_NAMES = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_MOVE_NOTHING = ("wait_tensor", "_wrap_tensor_autograd")


def _key(a):
    """A hashable signature of an argument: a tensor's layout, a
    sequence's items, anything else itself."""
    if isinstance(a, torch.Tensor):
        return (a.shape, a.stride(), a.dtype, a.device)
    if isinstance(a, (list, tuple)):
        return tuple(map(_key, a))
    if isinstance(a, dict):
        return tuple((k, _key(v)) for k, v in a.items())
    hash(a)
    return a


def _tensors(tree, out=None):
    """The tensors of an op's arguments or results (nested in lists,
    tuples and dicts), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            _tensors(t, out)
    elif isinstance(tree, dict):
        for t in tree.values():
            _tensors(t, out)
    return out


def _collective(func):
    """The collective's name (``COLLECTIVES``, or its own) for a
    ``_c10d_functional`` or ``_dtensor`` collective op; "" for an op
    of those namespaces that moves nothing; None for any other op."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "_dtensor"):
        return None
    name = func._overloadpacket.__name__
    if name in _MOVE_NOTHING:
        return ""
    if ns == "_dtensor" and name not in COLLECTIVES:
        return None
    return COLLECTIVES.get(name, name)


def _subclass(types, name: str, module: str) -> bool:
    mod = sys.modules.get(module)
    cls = getattr(mod, name, None) if mod is not None else None
    return cls is not None and any(issubclass(t, cls) for t in types)


def _faking() -> bool:
    """True under a FakeTensorMode (DTensor's sharding propagation runs
    its ops on fake tensors), which sits below this mode on the stack:
    what runs there is no op of the step."""
    mod = sys.modules.get("torch._subclasses.fake_tensor")
    return mod is not None and any(
        isinstance(m, mod.FakeTensorMode)
        for m in _get_current_dispatch_mode_stack())


class TraceCost(TorchDispatchMode):
    """Counts what the ops run under it would cost: ``with TraceCost()
    as tc: step(...)``.  Read ``flops``, ``bytes``, ``kernels``,
    ``peak_bytes``, ``compute_s``, ``memory_s``, ``collectives`` and
    ``collective_bytes`` after.  ``groups``: process-group name -> mesh
    axis, to file each collective under the axis it runs over."""

    def __init__(self, groups=None):
        super().__init__()
        self.groups = dict(groups or {})
        # name -> {"calls", "bytes", "by_axis": {axis: bytes}}
        self.collectives = {}
        self.ops = 0
        self.flops_by_type = collections.Counter()     # products only
        self.bytes = 0                                 # outside kernels
        self.kernels = {}       # name -> {calls, flops, bytes, seconds}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._refs = {}         # id(storage) -> its weak reference
        self._in_kernel = 0
        self._token = None
        self._fresh = {}        # op -> makes fresh tensors only
        self._layouts = {}      # (op, argument signature) -> outputs

    # -- the kernels' meta branch ------------------------------------------

    def kernel_call(self, name: str, cost, make):
        c = cost()
        k = self.kernels.setdefault(name, dict(calls=0, flops=0, bytes=0,
                                               seconds=0.0))
        k["calls"] += 1
        k["flops"] += c.flops
        k["bytes"] += c.bytes
        k["seconds"] += c.times_ms()[1] / 1e3
        self._in_kernel += 1
        try:
            return make()
        finally:
            self._in_kernel -= 1

    def __enter__(self):
        self._token = TRACE.set(self)
        return super().__enter__()

    def __exit__(self, *exc):
        TRACE.reset(self._token)
        return super().__exit__(*exc)

    # -- the ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _subclass(types, "DTensor", "torch.distributed.tensor"):
            return NotImplemented      # DTensor runs it: count its parts
        if _faking():
            return func(*args, **kwargs)   # DTensor's sharding propagation
        coll = _collective(func)
        if coll is not None:
            out = func(*args, **kwargs)
            self.ops += 1
            for t in _tensors(out):
                self._track(t.untyped_storage(), set())
            if coll:
                self._count_collective(coll, args, kwargs)
            return out
        out = self._run(func, args, kwargs)
        self.ops += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        seen = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            self._track(t.untyped_storage(), seen)
        if not self._in_kernel:
            self._count(func, args, kwargs, ins, outs, out, seen)
        return out

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``.  A meta op's outputs depend on its
        inputs' shapes, strides, types and its other arguments alone, so
        an op that makes fresh tensors (no view, no in-place write) is
        run once for each such signature, and later calls get new empty
        tensors of the same layout: a loop over time steps (the sLSTM's)
        runs Python's meta functions once, not once a step."""
        if func not in self._fresh:
            schema = func._schema
            self._fresh[func] = all(
                r.alias_info is None and str(r.type) == "Tensor"
                for r in schema.returns) and bool(schema.returns) and not any(
                a.alias_info is not None for a in schema.arguments)
        if not self._fresh[func]:
            return func(*args, **kwargs)
        try:
            key = (func, _key(args), _key(kwargs))
            layout = self._layouts.get(key)
        except TypeError:                     # an unhashable argument
            return func(*args, **kwargs)
        if layout is None:
            out = func(*args, **kwargs)
            many = isinstance(out, tuple)
            outs = out if many else (out,)
            self._layouts[key] = (many, [
                (t.shape, t.stride(), t.dtype, t.device) for t in outs]) \
                if all(t.is_meta for t in outs) else False
            return out
        if layout is False:                   # not on the meta device
            return func(*args, **kwargs)
        many, outs = layout
        made = tuple(torch.empty_strided(shape, stride, dtype=dtype,
                                         device=device)
                     for shape, stride, dtype, device in outs)
        return made if many else made[0]

    def _track(self, storage, seen) -> None:
        key = id(storage)
        if key in seen or key in self._refs:
            return
        n = storage.nbytes()

        def died(_ref, key=key, n=n):
            del self._refs[key]
            self.live_bytes -= n
        self._refs[key] = weakref.ref(storage, died)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _count(self, func, args, kwargs, ins, outs, out, seen) -> None:
        packet = func._overloadpacket
        if packet in PRODUCTS:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_by_type[ins[-1 if packet in (
                aten.addmm, aten.baddbmm) else 0].dtype] += flops
        written = [a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if not written:
            if packet in MAKERS or not ins:
                return                        # makes a tensor, moves none
            if all(id(t.untyped_storage()) in seen for t in outs):
                return                        # a view or a reshape
            if packet in GATHERS:
                index = [t for t in ins if not t.is_floating_point()]
                self.bytes += nbytes(*index) + 2 * nbytes(*outs)
                return
            self.bytes += nbytes(*ins) + nbytes(*outs)
            return
        dst = [kwargs[n] if n in kwargs else args[i]
               for i, a in enumerate(func._schema.arguments)
               if (n := a.name) in written and (n in kwargs or i < len(args))]
        dst_ids = {id(t) for t in _tensors(dst)}
        reads = [t for t in ins if id(t) not in dst_ids]
        if packet in SCATTERS:
            values = max((nbytes(t) for t in reads if t.is_floating_point()),
                         default=0)
            self.bytes += nbytes(*reads) + values
            return
        written_bytes = nbytes(*_tensors(dst))
        self.bytes += nbytes(*reads) + written_bytes + (
            0 if packet in OVERWRITES else written_bytes)

    def _count_collective(self, name, args, kwargs) -> None:
        """Operand bytes (the tensors passed in) and one call, filed
        under the mesh axis of the op's group (its string argument)."""
        group = [a for a in list(args) + list(kwargs.values())
                 if isinstance(a, str) and a in self.groups]
        axis = self.groups[group[0]] if group else "other"
        n = nbytes(*_tensors((args, kwargs)))
        c = self.collectives.setdefault(name, dict(calls=0, bytes=0,
                                                   by_axis={}))
        c["calls"] += 1
        c["bytes"] += n
        c["by_axis"][axis] = c["by_axis"].get(axis, 0) + n

    # -- totals ---------------------------------------------------------------

    @property
    def collective_bytes(self) -> int:
        return sum(c["bytes"] for c in self.collectives.values())

    def collective_bytes_by_axis(self) -> dict:
        out = collections.Counter()
        for c in self.collectives.values():
            out.update(c["by_axis"])
        return dict(out)

    @property
    def product_flops(self) -> float:
        return float(sum(self.flops_by_type.values()))

    @property
    def flops(self) -> float:
        """Products and every kernel call's f32 operations."""
        return self.product_flops + sum(k["flops"]
                                        for k in self.kernels.values())

    @property
    def total_bytes(self) -> float:
        return self.bytes + sum(k["bytes"] for k in self.kernels.values())

    @property
    def compute_s(self) -> float:
        """Products at their type's peak (float32 on CUDA cores, the
        others on tensor cores at the bfloat16 rate), kernels at their
        own rate."""
        return sum(n / (F32_OPS_PER_S if dt == torch.float32
                        else BF16_OPS_PER_S)
                   for dt, n in self.flops_by_type.items()) + sum(
            k["seconds"] for k in self.kernels.values())

    @property
    def memory_s(self) -> float:
        return self.total_bytes / HBM_BYTES_PER_S
