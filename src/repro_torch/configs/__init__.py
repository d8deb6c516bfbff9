"""Model configurations (counterpart of ``src/repro/configs/``): the
``ModelConfig`` dataclass, ``reduced`` for CPU-sized copies, and
``get_config`` for the architectures this port has."""

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.registry import ARCH_IDS, get_config

__all__ = ["ModelConfig", "reduced", "ARCH_IDS", "get_config"]
