"""Plain PyTorch log-bin histogram helpers (counterpart of
``src/repro/kernels/latency_histogram/ref.py``).

Bin 0 is the underflow bucket (< ``lo``), bin ``B-1`` the overflow bucket
(>= ``hi``), and the ``B-2`` interior bins are log-spaced on ``[lo, hi)``.
The group id encodes (node, read/write) as ``g = node * 2 + is_read``.

The logarithms are taken in float64 and rounded to float32: that is the
correctly rounded f32 log, which is what puts latencies sitting exactly on
a decade edge (10, 100 and 1000 ms at ``lo=1, hi=1e4, B=128``) into the
same bins as the reference (32, 64 and 95). The reference's own bins rest
on its platform's f32 log: where XLA's CPU log is an ulp off the correctly
rounded one, a latency within an ulp or so of an edge lands one bin over
(``tests/test_torch_telemetry.py`` counts them). ``chunk_replay``'s kernel
computes the same expression the same way (``kernels/csrc/log_bins.cuh``);
``latency_histogram``'s counts the rule's thresholds below a latency
(:func:`bin_thresholds` is their plain version).

Rows whose group lies outside ``[0, G)`` are dropped, as the kernel drops
them.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bin_index", "bin_thresholds", "bin_edges", "latency_histogram_ref",
           "latency_histogram_chunks_ref"]


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


def _bits(x: float) -> int:
    return int(torch.tensor(x, dtype=torch.float32).view(torch.int32))


def bin_thresholds(lo: float, hi: float, num_bins: int) -> torch.Tensor:
    """The ``num_bins - 1`` f32 thresholds of :func:`bin_index`: ``e_k`` is
    the least f32 with ``bin_index(e_k) >= k``, found by bisection over the
    bit patterns of ``[lo, hi]`` (positive floats order like their bits).
    The rule is monotone, so the bin of a non-NaN latency is the number of
    thresholds at or below it. For the tests: the kernel builds the same
    table on the card with its own rule."""
    k = torch.arange(1, num_bins, dtype=torch.int64)
    a = torch.full_like(k, _bits(lo))
    b = torch.full_like(k, _bits(hi))
    for _ in range(32):
        m = a + (b - a) // 2
        reach = bin_index(m.to(torch.int32).view(torch.float32), lo, hi, num_bins).long() >= k
        b = torch.where(reach, m, b)
        a = torch.where(reach, a, m + 1)
    return a.to(torch.int32).view(torch.float32)


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
