"""DeepSeekMoE-16B [arXiv:2401.06066] — fine-grained experts.

28L d_model=2048 16H (kv=16) d_ff_expert=1408 vocab=102400,
64 routed experts top-6 + 2 shared experts.
A copy of ``repro.configs.deepseek_moe_16b``
(tests/test_torch_moe.py holds it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                # kept equal to expert dim for the dense path
    vocab_size=102400,
    source="arXiv:2401.06066",
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    d_ff_expert=1408,
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=10000.0,
))
