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
"""

from __future__ import annotations

import torch


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
