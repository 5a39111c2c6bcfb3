"""xLSTM-125M [arXiv:2405.04517] — sLSTM + mLSTM blocks, attention-free.

12L d_model=768 4H d_ff=0 vocab=50304.  d_ff=0: xLSTM blocks carry their own
up-projections (mLSTM pre-up x2, sLSTM gated post-FFN) instead of a separate
transformer FFN.  We alternate mLSTM and sLSTM (one sLSTM every 2nd block),
matching the paper's mixed xLSTM[a:b] notation at small scale.
A copy of ``repro.configs.xlstm_125m``
(tests/test_torch_xlstm.py holds it equal to the reference's).
"""

from repro_torch.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    source="arXiv:2405.04517",
    # mLSTM internals: matrix-memory heads; state per head = head_dim.
    ssm_expand=2,            # mLSTM pre-up-projection factor
    ssm_head_dim=384,        # d_inner / num_heads = 1536 / 4
    ssm_state=384,           # matrix memory is head_dim x head_dim
    xlstm_slstm_every=2,     # blocks 1,3,5,... are sLSTM
    norm="layernorm",
    gated_mlp=True,
    tie_embeddings=True,
))
