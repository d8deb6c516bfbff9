"""qwen3-1.7b — dense GQA with qk_norm [hf:Qwen/Qwen3-8B; hf] (counterpart
of ``src/repro/configs/qwen3_1_7b.py``). The serving path's default
architecture."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    hot_embed_rows=4096,  # 151936-row table: embedding dominates the params
)
