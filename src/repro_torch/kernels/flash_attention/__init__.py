"""Flash attention (forward; GQA, causal, sliding window): CUDA kernel,
plain version, wrapper."""
