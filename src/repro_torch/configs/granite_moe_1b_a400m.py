"""granite-moe-1b-a400m — 32 experts top-8 [hf:ibm-granite/granite-3.0-1b] (counterpart of
``src/repro/configs/granite_moe_1b_a400m.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,  # per-expert width
    vocab_size=49155,
    head_dim=64,
    num_experts=32,
    top_k=8,
    tie_embeddings=True,
    hot_expert_slots=6,
    hot_embed_rows=1024,
)
