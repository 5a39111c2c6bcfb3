"""Hand-written CUDA kernels for Hopper, one per TPU kernel of the
reference (``src/repro/kernels``).

Each kernel package ships:
  csrc/<name>.cu  -- the CUDA C++ source for sm_90a, with a plain C entry
                     point (built and loaded by ``build.py``)
  <name>/ref.py   -- the plain PyTorch version of the same function
  <name>/ops.py   -- the wrapper: the plain version for a CPU tensor,
                     the kernel for a CUDA tensor (or it raises), and a
                     launch count

The wrapper decides by the tensor's device alone.  There is no switch
and no fallback: a CUDA tensor never reaches the plain version's
forward.  No TPU kernel of the reference has a backward, so where the
training path needs a gradient (rmsnorm, flash_attention, ssd_scan) the
wrapper launches through ``with_grad``: under grad mode, where an input
needs a gradient, ``KernelFunction`` runs the kernel forward with the
plain version's autograd, recomputed from the saved inputs, as its
backward (``plain_backward``).  The other wrappers raise on a CUDA
input that needs a gradient under grad mode.  None returns a detached
output.

Kernels ported: groupnorm_silu (diffusion U-Net hot spot), rmsnorm,
flash_attention (prefill) and decode_attention (flash-decode over the
KV cache) on the transformer's serving path, and ssd_scan (the Mamba2
chunk scan) on zamba2's.  That is every TPU kernel of the reference.

On the meta device (shapes and types, no storage: the dry run,
``repro_torch.launch.dryrun``) a wrapper makes the same checks, runs
through ``with_grad`` as on the card, and returns its outputs' shapes
and types with no arithmetic (``meta_call``).  Each ``ops.py`` has a
``cost(...)``: the function's operations, the bytes it must move
(each input read once, each output written once) and the rate its
operations run at on the card, from its inputs' shapes and types
(``KernelCost``; the card's rates below).
"""

from __future__ import annotations

import contextvars
import dataclasses
import sys

import torch

# NVIDIA H100 SXM, data sheet (dense rates, 700 W power limit): the
# bounds of the kernels and the dry run's roofline.  TF32 is off on the
# port's paths, so float32 products run at the float32 rate.
CARD = "NVIDIA H100 SXM (data sheet)"
HBM_BYTES = 80 * 2**30             # device memory, 80 GiB (H100 80GB HBM3)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12              # float32 outside tensor cores
TF32_OPS_PER_S = 495e12            # TF32 tensor cores; flash_attention and
                                   # ssd_scan keep f32 with 3xTF32
BF16_OPS_PER_S = 989e12            # bfloat16 tensor cores
TF32_PER_F32_OP = 3                # precision with 3xTF32: lo*hi + hi*lo
                                   # + hi*hi per f32 product
# The links of the production meshes (launch.dryrun: 16 x 16 and 2 x 16
# x 16 cards), 256 H100 SXM as 32 nodes of 8: NVLink 4 inside a node,
# 900 GB/s a GPU in both directions together (NVIDIA H100 data sheet),
# 450e9 each way; between nodes one 400 Gb/s NDR InfiniBand link a GPU
# (NVIDIA DGX H100 data sheet), 50e9 each way.  A collective is priced
# at the slowest link its group crosses: NVLink where the group's ranks
# lie in one node, the node link otherwise (``launch.dryrun.link_rates``).
GPUS_PER_NODE = 8
NVLINK_BYTES_PER_S = 450e9
NODE_LINK_BYTES_PER_S = 50e9


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """One call's work: ``flops`` operations of the function,
    ``bytes`` moved (each input read once, each output written once),
    and the card's rate for them: ``per_op`` device operations each at
    ``ops_per_s``."""
    flops: int
    bytes: int
    ops_per_s: float = F32_OPS_PER_S
    per_op: int = 1

    def times_ms(self):
        """(bytes at HBM_BYTES_PER_S, operations at their rate), ms."""
        return (self.bytes / HBM_BYTES_PER_S * 1e3,
                self.per_op * self.flops / self.ops_per_s * 1e3)

    @property
    def ms(self) -> float:
        """The least time the card could take: the larger term."""
        return max(self.times_ms())

    @property
    def bound_by(self) -> str:
        t_bytes, t_ops = self.times_ms()
        return "bytes" if t_bytes >= t_ops else "operations"


def product_rate(*operands, f32=(TF32_OPS_PER_S, TF32_PER_F32_OP)):
    """(ops_per_s, per_op) of a kernel's products on ``operands``: all
    bfloat16, one operation each at BF16_OPS_PER_S (bfloat16 tensor
    cores, the least time the card could take for them); any float32
    operand, ``f32``, the kernel's float32 rate (3xTF32 by default)."""
    if all(t.dtype == torch.bfloat16 for t in operands):
        return BF16_OPS_PER_S, 1
    return f32


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# The trace counter of the current context (``launch.trace_cost``), or
# None: it receives the meta branch's kernel calls.
TRACE = contextvars.ContextVar("repro_torch_kernel_trace", default=None)


def meta_call(name: str, cost, make):
    """The meta branch of kernel ``name``'s wrapper: ``make()`` returns
    the outputs on the meta device (``torch.empty_like``: no
    arithmetic).  Under a trace counter the call is recorded as one call
    of the kernel at ``cost()`` (a ``KernelCost``), and the ops ``make``
    runs count as its outputs' memory only."""
    trace = TRACE.get()
    return make() if trace is None else trace.kernel_call(name, cost, make)


def refuse_dtensor(name: str, *ts) -> None:
    """Raise for a DTensor among ``ts``: a wrapper hands raw pointers
    to its kernel (``launch``), and a DTensor's are not its local
    block's.  Sharded models reach the wrappers through ``local_map``
    (``repro_torch.models.params.local_call``) with plain local
    tensors."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is not None and any(isinstance(t, mod.DTensor) for t in ts):
        raise TypeError(f"{name}: got a DTensor; call the wrapper on each "
                        f"rank's local block (local_map)")


def launch(fn, index: int, *args) -> int:
    """Call the C entry ``fn(*args, stream)`` on the current stream of
    CUDA device ``index`` (a tensor's ``get_device()``), read anew on
    every call (under ``torch.cuda.graph`` it is the capture stream) as
    a raw handle, without building a ``torch.cuda.Stream``.  Enters
    ``torch.cuda.device`` only when ``index`` is not the current device,
    to keep the host cost of a launch low."""
    current = torch.cuda.current_device()
    if index != current:
        with torch.cuda.device(index):
            return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    return fn(*args, torch._C._cuda_getCurrentRawStream(current))


def plain_backward(ref, inputs, grads, **kw):
    """The gradient of ``ref(*inputs, **kw)`` for each input at
    ``grads`` (one per output), by autograd through the plain version
    re-run from detached copies of the inputs."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in inputs)
        return torch.autograd.grad(ref(*ins, **kw), ins, grads)


class KernelFunction(torch.autograd.Function):
    """``kernel(*inputs, **kw)`` forward, ``plain_backward(ref, ...)``
    backward."""

    @staticmethod
    def forward(ctx, kernel, ref, kw, *inputs):
        ctx.save_for_backward(*inputs)
        ctx.ref, ctx.kw = ref, kw
        return kernel(*inputs, **kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        return (None, None, None,
                *plain_backward(ctx.ref, ctx.saved_tensors, grads, **ctx.kw))


def with_grad(kernel, ref, inputs, **kw):
    """``kernel(*inputs, **kw)``, through ``KernelFunction`` under grad
    mode where an input needs a gradient; launched directly otherwise,
    as serving does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return KernelFunction.apply(kernel, ref, kw, *inputs)
    return kernel(*inputs, **kw)
