"""Zamba2-2.7B [arXiv:2411.15242] — Mamba2 backbone + weight-shared attention.

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000, ssm_state=64.
One *shared* (single set of weights) attention+MLP block is applied every
6th backbone layer, zamba-style.  A copy of ``repro.configs.zamba2_2_7b``
(tests/test_torch_llm_config.py holds it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    source="arXiv:2411.15242",
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,          # 80 ssm heads = 5120 / 64
    shared_attn_every=6,
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=10000.0,
))
