"""Chunked SSD (Mamba2) scan: CUDA kernel, plain version, wrapper."""
