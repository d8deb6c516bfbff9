"""Plain PyTorch version of the hot-row gather (counterpart of
``src/repro/kernels/hot_gather/ref.py``): the yardstick the CUDA kernel in
``csrc/hot_gather.cu`` is held to, and what the wrapper runs for tensors on
the CPU."""

from __future__ import annotations

import torch

__all__ = ["hot_gather_ref"]


def hot_gather_ref(tokens: torch.Tensor, slot_map: torch.Tensor, hot_table: torch.Tensor):
    """tokens ``[T]``, slot_map ``[V]`` (-1 = cold), hot_table ``[R, D]`` ->
    ``(rows [T, D]`` in the table's dtype, zeros on a miss, ``hit [T] bool)``."""
    slots = slot_map[tokens.long()]
    hit = slots >= 0
    rows = hot_table[torch.clamp_min(slots, 0).long()]
    rows = torch.where(hit[:, None], rows, torch.zeros((), dtype=hot_table.dtype, device=rows.device))
    return rows, hit
