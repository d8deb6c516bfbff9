"""Plain PyTorch version of ``trace_window``: the request fields of a
window of trace positions, drawn from the trace's threefry stream
(``kvsim/prng.py``), the yardstick the CUDA kernel in
``csrc/trace_window.cu`` is held to and what the wrapper runs for tensors
on the CPU.

A position ``p`` of the trace ``generate_trace(cfg, seed)`` is a function of
``p`` alone under the partitionable threefry layout, so any window is the
counters of its positions. Per position, with the subkeys of
:class:`WindowParams`:

  * the key: skewed, ``bernoulli(k_hot, hot_traffic)`` picks between
    ``randint(k_key, 0, n_hot)`` and ``randint(fold_in(k_key, 1), n_hot,
    K)``; uniform, ``randint(k_key, 0, K)``;
  * the node: the key's natural node (``natural[key]``), or with
    ``1 - affinity`` the node ``randint(k_other, 1, N)`` places after it;
    with ``diurnal_shifts`` rotated by ``(p * shifts) // R``;
  * the read flag: ``bernoulli(k_rw, read_fraction)``.

Each ``randint`` takes two words (of the two halves of its key's
``split``), each ``bernoulli`` one: 9 threefry blocks a position skewed,
6 uniform. Positions at or past ``R`` give well-typed values the caller
masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["WindowParams", "SLAB", "window_draws", "trace_window_ref"]

SLAB = 1 << 22  # positions a slab: bounds the plain version's temporaries
MASK32 = 0xFFFFFFFF

# Key slots of WindowParams.keys.
K_HOT, K_DRAW_HI, K_DRAW_LO, K_COLD_HI, K_COLD_LO, K_SHIFT_HI, K_SHIFT_LO, K_NODE, K_RW = range(9)


class WindowParams(NamedTuple):
    """What a window of a trace needs besides its positions: the derived
    subkeys, ``randint``'s reductions and the f32 thresholds.

    ``keys`` holds nine ``(u32, u32)`` keys in the order of the ``K_*``
    slots: ``k_hot``; both halves of ``split(k_key)`` (the key draw, hot or
    uniform), of ``split(fold_in(k_key, 1))`` (the cold draw) and of
    ``split(k_other)`` (the shift); ``k_node``; ``k_rw``. ``draws`` holds
    ``(minval, span, multiplier)`` of the key, cold and shift draws."""

    keys: tuple[tuple[int, int], ...]
    draws: tuple[tuple[int, int, int], ...]
    p_hot: float  # f32 thresholds, as bernoulli rounds them
    p_stay: float
    p_read: float
    skewed: bool
    num_nodes: int
    diurnal_shifts: int
    num_requests: int

    def words(self) -> list[int]:
        """The 27 u32 words the CUDA kernel reads: 18 key words, then the
        three draws' spans, multipliers and minvals (two's complement)."""
        out = [w for key in self.keys for w in key]
        out += [d[1] for d in self.draws] + [d[2] for d in self.draws]
        out += [d[0] & MASK32 for d in self.draws]
        return out


def _prng():
    # kvsim imports this package (through its engine), so the stream's
    # module is imported at call time, once kvsim is whole.
    from repro_torch.kvsim import prng

    return prng


def _randint(params: WindowParams, slot: int, hi_key: int, pos: torch.Tensor) -> torch.Tensor:
    prng = _prng()
    minval, span, mult = params.draws[slot]
    higher = prng.bits(params.keys[hi_key], pos)
    lower = prng.bits(params.keys[hi_key + 1], pos)
    offset = (((higher % span) * mult + (lower % span)) & MASK32) % span
    return offset + minval


def _bernoulli(params: WindowParams, key: int, p: float, pos: torch.Tensor) -> torch.Tensor:
    prng = _prng()
    return prng.uniform_bits(prng.bits(params.keys[key], pos)) < p


def window_draws(
    pos: torch.Tensor, params: WindowParams, natural: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(keys int32, nodes int32, is_read bool)`` at trace positions
    ``pos`` (int64, any shape, on ``natural``'s device)."""
    if params.skewed:
        hot = _randint(params, 0, K_DRAW_HI, pos)
        cold = _randint(params, 1, K_COLD_HI, pos)
        keys = torch.where(_bernoulli(params, K_HOT, params.p_hot, pos), hot, cold)
    else:
        keys = _randint(params, 0, K_DRAW_HI, pos)
    n = params.num_nodes
    nat = natural[keys].to(torch.int64)
    shift = _randint(params, 2, K_SHIFT_HI, pos)
    nodes = torch.where(_bernoulli(params, K_NODE, params.p_stay, pos), nat, (nat + shift) % n)
    if params.diurnal_shifts > 0:
        nodes = (nodes + (pos * params.diurnal_shifts) // params.num_requests) % n
    return keys.to(torch.int32), nodes.to(torch.int32), _bernoulli(params, K_RW, params.p_read, pos)


def trace_window_ref(
    start: int, count: int, params: WindowParams, natural: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(keys [count] int32, nodes [count] int32, is_read [count] bool)`` of
    positions ``[start, start + count)``, on ``natural``'s device, in slabs
    of :data:`SLAB` positions."""
    dev = natural.device
    slabs = [window_draws(torch.arange(lo, min(lo + SLAB, start + count), dtype=torch.int64,
                                       device=dev), params, natural)
             for lo in range(start, start + count, SLAB)]
    if not slabs:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    return tuple(torch.cat(x) if len(slabs) > 1 else x[0] for x in zip(*slabs))
