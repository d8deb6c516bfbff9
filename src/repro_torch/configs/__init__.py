"""Model configurations (counterpart of ``src/repro/configs/``): the
``ModelConfig`` dataclass, ``reduced`` for CPU-sized copies, ``get_config``
for the reference's ten architectures, and the four shape cells
(``ShapeConfig``, ``SHAPES``, ``get_shape``, ``cells``)."""

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced
from repro_torch.configs.registry import ARCH_IDS, cells, get_config, get_shape

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "reduced", "ARCH_IDS", "get_config", "get_shape",
           "cells"]
