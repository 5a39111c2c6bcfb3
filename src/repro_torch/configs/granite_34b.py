"""Granite-34B-Code [arXiv:2405.04324] — GPT-BigCode style, MQA.

88L d_model=6144 48H (kv=1, multi-query) d_ff=24576 vocab=49152.
Adaptation, kept from the reference: learned absolute positions -> RoPE.
A copy of ``repro.configs.granite_34b`` (tests/test_torch_llm_config.py
holds it equal to the reference's).  Its 88 layers are 126.5 GiB of f32
weights, more than one 80 GB card holds: on the card it runs cut in
depth (``dataclasses.replace(CONFIG, num_layers=44)``, or the serve
launcher's ``--layers 44``).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    source="arXiv:2405.04324",
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    rope_theta=10000.0,
))
