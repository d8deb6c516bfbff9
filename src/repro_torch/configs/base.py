"""The architecture config (counterpart of ``src/repro/configs/base.py``).

``ModelConfig`` is the reference's dataclass field for field, so a config
carries across with ``ModelConfig(**dataclasses.asdict(ref_cfg))``. The four
input-shape cells are global (``SHAPES``, each a ``ShapeConfig``), with the
reference's names and values; ``Model.input_specs`` and ``Model.make_batch``
turn a cell into a batch.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # -- attention details --
    qk_norm: bool = False  # qwen3-style RMSNorm on q/k heads
    rope_theta: float = 1e4
    window: int = 0  # sliding-window size for local attention (0 = full)
    pos: str = "rope"  # rope | sinusoidal (whisper-style, added at embed)

    # -- MoE --
    num_experts: int = 0  # routed experts (0 = dense FFN)
    num_shared_experts: int = 0
    top_k: int = 0

    # -- hybrid (RecurrentGemma-style) --
    attention_period: int = 0  # every k-th layer is (local) attention, rest RG-LRU
    lru_width: int = 0  # recurrence width (0 -> d_model)

    # -- ssm (RWKV6) --
    rwkv_head_dim: int = 64

    # -- encoder-decoder (Whisper-style) --
    encoder_layers: int = 0
    num_frames: int = 0  # stub audio frontend: precomputed frame embeddings

    # -- vlm (LLaVA-style) --
    num_patches: int = 0  # stub vision frontend: precomputed patch embeddings

    # -- norms / activations --
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu

    # -- MoE routing (GShard-style capacity dispatch) --
    moe_group_size: int = 512  # tokens per dispatch group
    moe_capacity_factor: float = 1.25
    # einsum — one-hot dispatch/combine matmuls (GShard baseline)
    # sort   — argsort + gather/scatter (no dispatch matmul FLOPs; §Perf B5)
    moe_impl: str = "einsum"
    # With the Redynis replica cache on, the cold (all-to-all) capacity
    # shrinks to this fraction and the hot local path absorbs the rest.
    moe_cold_capacity: float = 0.5
    moe_hot_capacity: float = 0.75
    moe_aux_weight: float = 0.01  # load-balance aux loss weight

    # -- Redynis integration --
    hot_expert_slots: int = 0  # R replica slots per layer (0 = technique off)
    hot_embed_rows: int = 0  # hot-row embedding cache size (0 = off)
    sweep_period: int = 50  # steps between placement-daemon sweeps
    ownership_h: float = 0.0  # ownership coefficient (0 -> 1/n at runtime)
    traffic_decay: float = 0.98  # EMA decay of traffic stats per sweep

    # -- distribution layout (hillclimb knob; see launch/sharding.py) --
    #   tp    — Megatron-style: FSDP over data × TP over model (baseline)
    #   fsdp  — ZeRO-3-pure: params sharded over (data×model) jointly,
    #           batch over all axes, no tensor parallelism (activation
    #           all-reduces vanish; per-layer param all-gathers instead)
    #   serve — weights-stationary decode: params replicated over data,
    #           TP over model (no per-step FSDP gathers at inference)
    layout: str = "tp"

    # -- numerics / training --
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full  (activation checkpointing per layer)
    tie_embeddings: bool = False
    xent_chunks: int = 8  # token chunks for the vocab-sharded loss
    attn_chunk: int = 1024  # q/kv block size for blockwise attention

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab rounded up to 512 so the table always
        splits across the model axis (and rows stay MXU-aligned). Logits for
        the padding rows are masked to -inf (``src/repro/dist.py``)."""
        return ((self.vocab_size + 511) // 512) * 512

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid-local-attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decode(self) -> bool:
        """Encoder-only archs have none; everything assigned here decodes."""
        return True


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests (small layers/width/vocab,
    few experts) — structure preserved, scale removed."""
    small = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.attention_period else 2),
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        num_experts=min(cfg.num_experts, 8),
        num_shared_experts=min(cfg.num_shared_experts, 2),
        top_k=min(cfg.top_k, 2),
        lru_width=128 if cfg.lru_width else 0,
        window=min(cfg.window, 64) if cfg.window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        num_frames=min(cfg.num_frames, 32),
        num_patches=min(cfg.num_patches, 16),
        hot_expert_slots=min(cfg.hot_expert_slots, 4),
        hot_embed_rows=min(cfg.hot_embed_rows, 64),
        remat="none",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
