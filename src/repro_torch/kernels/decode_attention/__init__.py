"""Flash-decode: one query token per sequence against a KV cache.  CUDA
kernel, plain version, wrapper."""
