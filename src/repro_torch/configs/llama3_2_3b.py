"""llama3.2-3b — small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B] (counterpart of
``src/repro/configs/llama3_2_3b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    rope_theta=5e5,
    tie_embeddings=True,
    hot_embed_rows=4096,
)
