"""Whisper-tiny [arXiv:2212.04356] — encoder-decoder audio backbone.

4L enc + 4L dec, d_model=384 6H d_ff=1536 vocab=51865.
The mel-spectrogram + conv feature extractor is a STUB per the assignment
carve-out: models.api.extra_input_specs() provides precomputed frame
embeddings (batch, num_audio_frames, d_model).
A copy of ``repro.configs.whisper_tiny``
(tests/test_torch_whisper.py holds it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,              # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    source="arXiv:2212.04356",
    encoder_layers=4,
    num_audio_frames=1500,
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    rope_theta=10000.0,        # adaptation: sinusoidal/learned -> RoPE for
                               # long decode shapes (as in the reference)
))
