"""Plain PyTorch log-bin histogram helpers (counterpart of
``src/repro/kernels/latency_histogram/ref.py``).

Bin 0 is the underflow bucket (< ``lo``), bin ``B-1`` the overflow bucket
(>= ``hi``), and the ``B-2`` interior bins are log-spaced on ``[lo, hi)``.
The group id encodes (node, read/write) as ``g = node * 2 + is_read``.

The logarithms are taken in float64 and rounded to float32: that is the
correctly rounded f32 log, which is what puts latencies sitting exactly on
a decade edge (10, 100 and 1000 ms at ``lo=1, hi=1e4, B=128``) into the
same bins as the reference (32, 64 and 95). Both CUDA kernels
(``chunk_replay`` and ``latency_histogram``) compute the same expression
the same way (``kernels/csrc/log_bins.cuh``).

Rows whose group lies outside ``[0, G)`` are dropped, as the kernel drops
them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bin_index", "bin_edges", "latency_histogram_ref", "latency_histogram_chunks_ref"]


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


def latency_histogram_chunks_ref(
    lat: torch.Tensor,  # [R] f32 per-request latency (ms)
    group: torch.Tensor,  # [R] int group id in [0, G)
    weight: torch.Tensor,  # [R] f32 per-request weight (0 masks padding)
    *,
    num_groups: int,
    num_bins: int,
    lo: float,
    hi: float,
    rows_per_chunk: int,
) -> torch.Tensor:
    """Per-chunk histograms ``[C, G, B]`` f32 in one flat fold over the
    combined ``(chunk, group, bin)`` index, chunk ``c`` holding rows
    ``[c * rows_per_chunk, (c + 1) * rows_per_chunk)`` (the last may be
    short). The same counts as ``C`` separate ``latency_histogram_ref``
    calls (the counterpart of ``telemetry.trace_histogram``'s bincount)."""
    r = lat.shape[0]
    c = -(-r // rows_per_chunk)
    g, b = num_groups, num_bins
    idx = bin_index(lat, lo, hi, b).long()
    group = group.long()
    inside = (group >= 0) & (group < g)
    chunk = torch.arange(r, device=lat.device) // rows_per_chunk
    flat = (chunk * g + group.clamp(0, g - 1)) * b + idx
    w = torch.where(inside, weight.to(torch.float32), torch.zeros((), device=lat.device))
    hist = torch.zeros(c * g * b, dtype=torch.float32, device=lat.device)
    hist.index_put_((flat,), w, accumulate=True)
    return hist.reshape(c, g, b)


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
    return latency_histogram_chunks_ref(
        lat, group, weight, num_groups=num_groups, num_bins=num_bins,
        lo=lo, hi=hi, rows_per_chunk=max(lat.shape[0], 1),
    ).sum(dim=0)
