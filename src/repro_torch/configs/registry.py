"""Architecture ids -> ``ModelConfig`` (counterpart of
``src/repro/configs/registry.py``). Only the architectures whose layers the
port runs are listed; any other id of the reference raises."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

__all__ = ["ARCH_IDS", "get_config"]

_MODULES = {"deepseek-moe-16b": "deepseek_moe_16b"}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported; ported: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").CONFIG
