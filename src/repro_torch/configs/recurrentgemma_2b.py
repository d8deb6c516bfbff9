"""recurrentgemma-2b — RG-LRU + local attention, 1:2 [arXiv:2402.19427; hf]
(counterpart of ``src/repro/configs/recurrentgemma_2b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,  # MQA
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    window=2048,  # local attention window
    attention_period=3,  # (rec, rec, attn) repeating
    lru_width=2560,
    hot_embed_rows=8192,  # 256000-row table, heaviest embedding of the pool
)
