"""Fused RMSNorm: CUDA kernel, plain version, wrapper."""
