"""The paper's GenAI substrate: DDIM pretrained on CIFAR-10.

A copy of ``repro.configs.ddim_cifar10`` (the port imports nothing of
``repro``; tests/test_torch_unet.py holds the copy equal to it).  Sizes
follow the DDPM/DDIM CIFAR-10 U-Net (~35.7M params); ``SMOKE`` is what
the CPU tests instantiate.
"""

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class UNetConfig:
    name: str = "ddim-cifar10"
    image_size: int = 32
    in_channels: int = 3
    base_channels: int = 128
    channel_mults: Tuple[int, ...] = (1, 2, 2, 2)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    num_groups: int = 32
    dropout: float = 0.0
    num_train_timesteps: int = 1000
    dtype: str = "float32"


CONFIG = UNetConfig()

SMOKE = UNetConfig(
    name="ddim-cifar10-smoke",
    image_size=16,
    base_channels=32,
    channel_mults=(1, 2),
    num_res_blocks=1,
    attn_resolutions=(8,),
    num_groups=8,
)
