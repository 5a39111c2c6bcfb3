"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128-expert MoE, top-8.

48L d_model=2048 32H (GQA kv=4) d_ff_expert=768 vocab=151936,
head_dim=128 (decoupled from d_model/num_heads), per-head q/k RMSNorm,
no shared experts.
A copy of ``repro.configs.qwen3_moe_30b_a3b``
(tests/test_torch_moe.py holds it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=768,
    vocab_size=151936,
    source="hf:Qwen/Qwen3-30B-A3B",
    head_dim=128,
    qk_norm=True,
    num_experts=128,
    experts_per_token=8,
    num_shared_experts=0,
    d_ff_expert=768,
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=1000000.0,
))
