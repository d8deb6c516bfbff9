"""Plain PyTorch log-bin histogram helpers (counterpart of
``src/repro/kernels/latency_histogram/ref.py``).

Bin 0 is the underflow bucket (< ``lo``), bin ``B-1`` the overflow bucket
(>= ``hi``), and the ``B-2`` interior bins are log-spaced on ``[lo, hi)``.
The group id encodes (node, read/write) as ``g = node * 2 + is_read``.

The logarithms are taken in float64 and rounded to float32: that is the
correctly rounded f32 log, which is what puts latencies sitting exactly on
a decade edge (10, 100 and 1000 ms at ``lo=1, hi=1e4, B=128``) into the
same bins as the reference (32, 64 and 95). The CUDA ``chunk_replay``
kernel computes the same expression the same way.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bin_index", "bin_edges", "latency_histogram_ref"]


def _log_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.to(torch.float64)).to(torch.float32)


def bin_index(lat: torch.Tensor, lo: float, hi: float, num_bins: int) -> torch.Tensor:
    """Log-spaced bucket index, elementwise (int32, same shape as ``lat``)."""
    lat = lat.to(torch.float32)
    f32 = dict(dtype=torch.float32, device=lat.device)
    lo_t, hi_t = torch.full((), lo, **f32), torch.full((), hi, **f32)
    inner = num_bins - 2
    t = _log_f32(torch.clamp_min(lat, 1e-30) / lo_t) / _log_f32(hi_t / lo_t)
    raw = torch.floor(t * torch.full((), float(inner), **f32)).to(torch.int32) + 1
    raw = torch.clamp(raw, 1, inner)
    idx = torch.where(lat >= hi_t, torch.full_like(raw, num_bins - 1), raw)
    return torch.where(lat < lo_t, torch.zeros_like(raw), idx)


def bin_edges(lo: float, hi: float, num_bins: int) -> np.ndarray:
    """Host-side ``[B+1]`` bin edges: ``[0, lo, ..., hi, inf]``."""
    inner = num_bins - 2
    interior = lo * (hi / lo) ** (np.arange(inner + 1) / inner)
    return np.concatenate([[0.0], interior, [np.inf]])


def latency_histogram_ref(
    lat: torch.Tensor,  # [R] f32 per-request latency (ms)
    group: torch.Tensor,  # [R] int group id in [0, G)
    weight: torch.Tensor,  # [R] f32 per-request weight (0 masks padding)
    *,
    num_groups: int,
    num_bins: int,
    lo: float,
    hi: float,
) -> torch.Tensor:
    """Fused bucketize + grouped scatter-add: ``[G, B]`` f32 counts."""
    idx = bin_index(lat, lo, hi, num_bins).long()
    hist = torch.zeros(num_groups * num_bins, dtype=torch.float32, device=lat.device)
    flat = group.long() * num_bins + idx
    hist.index_put_((flat,), weight.to(torch.float32), accumulate=True)
    return hist.reshape(num_groups, num_bins)
