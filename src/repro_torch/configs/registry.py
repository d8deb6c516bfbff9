"""Architecture ids -> ``ModelConfig`` (counterpart of
``src/repro/configs/registry.py``): the reference's ten ids in its order,
and the shape cells each architecture runs (``get_shape``, ``cells``)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced

__all__ = ["ARCH_IDS", "get_config", "get_shape", "cells", "reduced", "SHAPES"]

_MODULES = {
    "yi-9b": "yi_9b",
    "qwen3-1.7b": "qwen3_1_7b",
    "llama3.2-3b": "llama3_2_3b",
    "mistral-large-123b": "mistral_large_123b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "llava-next-34b": "llava_next_34b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-base": "whisper_base",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}").CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells(arch: str) -> list[str]:
    """The shape cells this arch runs: all but ``long_500k``, which only
    the sub-quadratic families (ssm, hybrid) run."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(arch).is_subquadratic:
        out.append("long_500k")
    return out
