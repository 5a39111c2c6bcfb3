"""Llama-3.2-Vision-90B [hf:meta-llama/Llama-3.2-11B-Vision, 90B sibling].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
100 layers = 80 self-attn + 20 cross-attn (one every 5th layer) consuming
vision tokens.  The ViT vision encoder + projector is a STUB per the
assignment carve-out: models.api.extra_input_specs() provides
precomputed, projected patch embeddings (batch, num_vision_tokens, d_model).
A copy of ``repro.configs.llama_3_2_vision_90b``
(tests/test_torch_vlm.py holds it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    source="hf:meta-llama/Llama-3.2-11B-Vision (90B sibling)",
    cross_attn_every=5,
    num_vision_tokens=1601,
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=500000.0,
))
