"""Fused GroupNorm + SiLU (NHWC): CUDA kernel, plain version, wrapper."""
