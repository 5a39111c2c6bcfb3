"""Model and run configuration for the port's transformer path.

The port's copy of ``repro.config``'s ``ModelConfig``, ``RunConfig``,
``ShapeConfig`` with the dry run's four ``SHAPES``, and
``smoke_variant`` (that module is jax-free, but the port imports nothing
of ``repro``).  The dataclasses are copied whole, so a config built here
is field-for-field the reference's (``dataclasses.asdict`` compares them
in ``tests/test_torch_llm_config.py``).

The registry holds the archs the port runs, all ten of the
reference's assigned ones: ``tinyllama-1.1b``, ``codeqwen1.5-7b``,
``minitron-4b``, ``granite-34b``, ``zamba2-2.7b``,
``deepseek-moe-16b``, ``qwen3-moe-30b-a3b``, ``whisper-tiny``,
``xlstm-125m`` and ``llama-3.2-vision-90b`` (one module each under
``repro_torch/configs/``).  ``get_config`` of a name it does not hold
raises ``KeyError`` with the name.

``DEFAULT_RULES`` and ``sharding_rules_for`` are the reference's
logical-axis rules, copied: they map each logical axis of the schemas
and activations to mesh axes, and drop a ``model`` mapping that the
config's size does not divide.  The port runs them over a
``torch.distributed`` device mesh (``repro_torch.launch.mesh``,
``repro_torch.launch.shardings``), every family, ``shard_kv_seq``
(the self caches' sequence axis on ``data``) included.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    source: str = ""                 # citation (arXiv / hf model card)

    # -- attention ----------------------------------------------------------
    head_dim: int = 0                # 0 -> d_model // num_heads
    rope_theta: float = 10000.0
    use_qkv_bias: bool = False       # qwen1.5-style
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q/k
    sliding_window: int = 0          # 0 = full attention (dense archs get a
                                     # windowed variant for long_500k at the
                                     # RunConfig level, not here)

    # -- MoE ------------------------------------------------------------
    num_experts: int = 0             # routed experts (0 = dense FFN)
    experts_per_token: int = 0       # top-k
    num_shared_experts: int = 0      # DeepSeekMoE shared experts
    d_ff_expert: int = 0             # per-expert hidden dim
    router_aux_coef: float = 0.01    # load-balance loss coefficient

    # -- SSM (Mamba2 / xLSTM) ------------------------------------------------
    ssm_state: int = 0               # state dim per head (Mamba2 N)
    ssm_conv: int = 4                # depthwise conv width
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64           # Mamba2 P (head dim of inner channels)
    xlstm_slstm_every: int = 0       # xLSTM: place an sLSTM block every k-th
                                     # layer (0 = no sLSTM, pure mLSTM)

    # -- hybrid (zamba2) ------------------------------------------------------
    shared_attn_every: int = 0       # one *weight-shared* attn block applied
                                     # every k-th backbone layer

    # -- VLM (mllama) ---------------------------------------------------------
    cross_attn_every: int = 0        # insert a cross-attn layer every k-th
    num_vision_tokens: int = 0       # stub frontend: precomputed patch embeds

    # -- audio (whisper) -------------------------------------------------------
    encoder_layers: int = 0          # >0 -> encoder-decoder model
    num_audio_frames: int = 0        # stub frontend: precomputed frame embeds

    # -- norms / activations ---------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    activation: str = "silu"         # silu | gelu | relu2
    gated_mlp: bool = True           # SwiGLU-style gate (False: plain MLP)
    tie_embeddings: bool = False

    dtype: str = "bfloat16"

    # ----------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, L, H, KV, hd = (self.d_model, self.num_layers, self.num_heads,
                           self.num_kv_heads, self.resolved_head_dim)
        n = self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                 # lm head
        attn = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.family == "ssm" and self.xlstm_slstm_every >= 0 and self.ssm_state == 0:
            # xLSTM: handled by its own counter below
            pass
        if self.is_moe:
            ffn = 3 * d * self.d_ff_expert * (self.num_experts
                                              + self.num_shared_experts)
            ffn += d * self.num_experts              # router
        elif self.gated_mlp:
            ffn = 3 * d * self.d_ff
        else:
            ffn = 2 * d * self.d_ff
        if self.family in ("ssm", "hybrid"):
            d_in = self.ssm_expand * d
            nheads = d_in // self.ssm_head_dim if self.ssm_head_dim else 0
            ssm = (d * (2 * d_in + 2 * self.ssm_state * (d_in // self.ssm_head_dim if False else 1)) )
            # simpler: in_proj (d -> 2*d_in + 2*groups*state + heads), out_proj
            ssm = d * (2 * d_in + 2 * self.ssm_state + nheads) + d_in * d
            per_layer = ssm
            if self.family == "hybrid":
                n += attn + ffn                      # one shared attn block
                per_layer += 0
            n += L * per_layer
        else:
            n += L * (attn + ffn)
        if self.cross_attn_every:
            n_cross = L // self.cross_attn_every
            n += n_cross * attn                      # cross-attn layers extra
        if self.is_encdec:
            n += self.encoder_layers * (attn + ffn)
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: shared + top-k routed)."""
        if not self.is_moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        full = self.param_count()
        all_expert = 3 * d * self.d_ff_expert * self.num_experts * L
        active_expert = 3 * d * self.d_ff_expert * self.experts_per_token * L
        return full - all_expert + active_expert


# ---------------------------------------------------------------------------
# Input shapes (the dry run's, ``repro_torch.launch.dryrun``)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ---------------------------------------------------------------------------
# Run configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RunConfig:
    """Execution knobs; orthogonal to the architecture."""
    use_pallas: bool = False         # True on TPU; CPU uses ref impls
    remat: str = "none"              # none | block | full
    fsdp: bool = False               # shard weights over the data axis too
    decode_window: int = 0           # >0: sliding-window decode attention
                                     # (enables long_500k for dense archs)
    kv_cache_dtype: str = "bfloat16" # or "int8" (beyond-paper)
    shard_kv_seq: bool = False       # sequence-shard the KV cache over data
                                     # axis (long_500k context parallelism)
    moe_capacity_factor: float = 1.25
    matmul_precision: str = "default"
    # ---- beyond-paper perf knobs (EXPERIMENTS.md §Perf) -------------------
    prefill_logits: str = "all"      # "last": only final-position logits
                                     # (vLLM semantics; kills the (B,S,V)
                                     # logits tensor + its collectives)
    decode_inplace_cache: bool = False
                                     # keep KV cache in the layer-scan CARRY
                                     # and update in place (donated buffer)
                                     # instead of restacking it through
                                     # scan ys -- removes a full-cache
                                     # copy per decode step
    decode_slice_reads: bool = False # with decode_window: dynamic-slice
                                     # only the window out of the cache
                                     # instead of masked full-cache reads
    prefill_parallel_q: bool = False # vectorize q chunks in chunked
                                     # attention (shardable seq axis for
                                     # archs whose heads don't divide the
                                     # model axis)
    decode_uniform_pos: bool = False # all sequences share one decode
                                     # position (serve_step): KV writes
                                     # lower to contiguous in-place DUS
                                     # instead of (CPU: f32-round-trip)
                                     # scatters


# Logical axis -> mesh axes mapping (MaxText-style sharding rules).
# Values are mesh-axis names or None (replicated).
DEFAULT_RULES: Tuple[Tuple[str, Optional[Tuple[str, ...]]], ...] = (
    ("batch", ("pod", "data")),
    ("seq", None),
    ("kv_seq", None),
    ("embed", None),
    ("heads", ("model",)),
    ("kv_heads", ("model",)),
    ("head_dim", None),
    ("mlp", ("model",)),
    ("experts", ("model",)),
    ("vocab", ("model",)),
    ("ssm_inner", ("model",)),
    ("ssm_state", None),
)


def sharding_rules_for(cfg: ModelConfig, mesh_axis_sizes: dict,
                       run: RunConfig = RunConfig()) -> dict:
    """Resolve DEFAULT_RULES against an arch: drop a 'model' mapping when the
    corresponding dimension is not divisible by the model-axis size, falling
    back to replication for that logical axis. This keeps every arch
    lowerable on the 16-way model axis (e.g. xlstm has 4 heads, whisper has
    6 heads and vocab 51865)."""
    model = mesh_axis_sizes.get("model", 1)
    rules = {}
    for name, axes in DEFAULT_RULES:
        if isinstance(axes, (tuple, list)):
            kept = tuple(a for a in axes if a in mesh_axis_sizes)
            rules[name] = kept or None
        else:
            rules[name] = axes if (axes is None or axes in mesh_axis_sizes) \
                else None

    def ok(dim: int) -> bool:
        return dim > 0 and dim % model == 0

    if not ok(cfg.num_heads * cfg.resolved_head_dim) or not ok(cfg.num_heads):
        rules["heads"] = None
    if not ok(cfg.num_kv_heads):
        rules["kv_heads"] = None
    ff = cfg.d_ff_expert if cfg.is_moe else cfg.d_ff
    if not ok(ff):
        rules["mlp"] = None
    if cfg.is_moe and not ok(cfg.num_experts):
        rules["experts"] = None
    if not ok(cfg.vocab_size):
        rules["vocab"] = None
    if cfg.family in ("ssm", "hybrid") and not ok(cfg.ssm_expand * cfg.d_model):
        rules["ssm_inner"] = None
    if run.shard_kv_seq:
        rules["kv_seq"] = ("data",)
    return rules


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not registered in repro_torch; "
                       f"registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    from repro_torch.configs import (  # noqa: F401
        codeqwen1_5_7b, deepseek_moe_16b, granite_34b, llama_3_2_vision_90b,
        minitron_4b, qwen3_moe_30b_a3b, tinyllama_1_1b, whisper_tiny,
        xlstm_125m, zamba2_2_7b)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced config of the same family: 2 layers, d_model<=512, <=4 experts.

    Used by per-arch smoke tests; the full config is only exercised via the
    dry-run (ShapeDtypeStruct, no allocation)."""
    d_model = min(cfg.d_model, 256)
    heads = max(2, min(cfg.num_heads, 4))
    kv = max(1, min(cfg.num_kv_heads, heads))
    while heads % kv:
        kv -= 1
    updates = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=d_model,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=(64 if cfg.head_dim else 0),
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
    )
    if cfg.is_moe:
        updates.update(num_experts=4,
                       experts_per_token=min(2, cfg.experts_per_token),
                       num_shared_experts=min(1, cfg.num_shared_experts),
                       d_ff_expert=128)
    if cfg.family in ("ssm", "hybrid"):
        updates.update(ssm_state=min(cfg.ssm_state, 16) or 16)
    if cfg.shared_attn_every:
        updates.update(shared_attn_every=2)
    if cfg.cross_attn_every:
        updates.update(cross_attn_every=2)
    if cfg.is_encdec:
        updates.update(encoder_layers=2, num_audio_frames=32)
    if cfg.num_vision_tokens:
        updates.update(num_vision_tokens=16)
    if cfg.xlstm_slstm_every:
        updates.update(xlstm_slstm_every=2)
    return replace(cfg, **updates)


__all__ = ["ModelConfig", "RunConfig", "DEFAULT_RULES", "sharding_rules_for",
           "register", "get_config", "list_archs", "smoke_variant",
           "replace"]
