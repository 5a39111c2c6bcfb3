"""Minitron-4B [arXiv:2407.14679] — pruned Nemotron.

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.
Nemotron family: squared-ReLU MLP (non-gated), head_dim=128.  A copy of
``repro.configs.minitron_4b`` (tests/test_torch_llm_config.py holds it
equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256000,
    source="arXiv:2407.14679",
    head_dim=128,
    norm="layernorm",
    activation="relu2",
    gated_mlp=False,
    rope_theta=10000.0,
))
