"""deepseek-moe-16b — fine-grained MoE, 2 shared + 64 routed top-6
[arXiv:2401.06066; hf] (counterpart of
``src/repro/configs/deepseek_moe_16b.py``). The flagship Redynis arch: many
small experts with zipfian routing traffic."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,  # MHA
    d_ff=1408,  # per-expert width (fine-grained)
    vocab_size=102400,
    head_dim=128,
    rope_theta=1e4,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    hot_expert_slots=8,  # Redynis replica cache (R slots per layer)
    hot_embed_rows=2048,
)
