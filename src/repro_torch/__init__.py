"""PyTorch/CUDA port of the batch-denoising provisioning system.

The paper's loop runs here on an NVIDIA GPU: bandwidth allocation (P1),
the STACKING batch plan (P2), validation and simulation, then each
planned batch as one batched DDIM step on the U-Net with per-sample
timesteps.  Module names mirror ``src/repro`` so each counterpart is easy
to find (``repro_torch/diffusion/unet.py`` <-> ``repro/diffusion/unet.py``).

The package imports ``torch`` and ``numpy`` only.  The NumPy planning
core it needs is copied here, not imported.  Public functions keep the
reference's NHWC layout.

Entry points take ``device=`` (default ``"cuda"``).  They never drop to
the CPU on their own: without a card they raise unless the caller asks
for ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when
    no card is present, so nothing silently runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run the plain PyTorch path")
    return dev
