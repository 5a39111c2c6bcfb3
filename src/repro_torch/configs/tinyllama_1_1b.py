"""TinyLlama-1.1B [arXiv:2401.02385] — llama2-architecture small model.

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.  A copy of
``repro.configs.tinyllama_1_1b`` (tests/test_torch_llm_config.py holds
it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    source="arXiv:2401.02385",
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=10000.0,
))
