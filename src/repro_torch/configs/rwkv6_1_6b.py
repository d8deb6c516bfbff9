"""rwkv6-1.6b — Finch, attention-free data-dependent decay [arXiv:2404.05892]
(counterpart of ``src/repro/configs/rwkv6_1_6b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # d_model / rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    hot_embed_rows=2048,
)
