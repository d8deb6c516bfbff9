"""whisper-base — enc-dec audio backbone, conv frontend stubbed [arXiv:2212.04356]
(counterpart of ``src/repro/configs/whisper_base.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,  # decoder
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,  # MHA
    d_ff=2048,
    vocab_size=51865,
    head_dim=64,
    norm="layernorm",
    act="gelu",
    pos="sinusoidal",
    num_frames=1500,  # 30 s of audio after the (stubbed) conv frontend
)
