"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — qwen1.5 architecture.

32L d_model=4096 32H (kv=32, MHA) d_ff=13440 vocab=92416; qkv bias.  A
copy of ``repro.configs.codeqwen1_5_7b`` (tests/test_torch_llm_config.py
holds it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    source="hf:Qwen/CodeQwen1.5-7B",
    use_qkv_bias=True,
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=1000000.0,
))
