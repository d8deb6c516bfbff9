"""llava-next-34b — VLM, anyres tiling (stub frontend) [hf:llava-hf/llava-v1.6]
(counterpart of ``src/repro/configs/llava_next_34b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    rope_theta=5e6,
    num_patches=2880,  # anyres: up to ~2880 image tokens (stub embeddings)
    hot_embed_rows=2048,
)
