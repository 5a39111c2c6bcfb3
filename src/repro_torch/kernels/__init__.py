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
and no fallback: a CUDA tensor never reaches the plain version.

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
