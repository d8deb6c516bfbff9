"""The histogram kernel's bin rule on the CPU: counting thresholds.

``kernels/latency_histogram`` bins a latency by counting the thresholds of
the log-bin rule at or below it: the rule is monotone in the latency, so
``B - 1`` thresholds fix it (``e_k``, the least f32 whose bin is at least
``k``), and NaN keeps the rule's own bin. ``ref.bin_thresholds`` finds them
the plain way, by bisection over f32 bit patterns with ``ref.bin_index``;
here the count is held to ``bin_index`` itself, exactly, on the values where
a slip would show: within 64 ulps of every edge, on 1 M log-uniform
latencies, and on the special values. On the card the kernel's own table is
held to its own rule on all 2**32 patterns (``ops.check_bin_rule``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.latency_histogram.ref import (  # noqa: E402
    bin_edges,
    bin_index,
    bin_thresholds,
)

RULES = [(1.0, 10_000.0, 128), (1.0, 10_000.0, 64), (5.0, 500.0, 32), (0.1, 1e6, 128),
         (1.0, 100.0, 8), (1.0, 10_000.0, 3), (0.25, 4_000.0, 200)]


def _count(lat: torch.Tensor, thresholds: torch.Tensor, lo, hi, num_bins) -> torch.Tensor:
    """The bin as the kernel takes it: thresholds at or below, NaN apart."""
    n = torch.searchsorted(thresholds, lat, right=True).to(torch.int32)
    nan_bin = bin_index(torch.tensor([float("nan")]), lo, hi, num_bins)
    return torch.where(torch.isnan(lat), nan_bin, n)


def _near_edges(lo, hi, num_bins, ulps=64) -> torch.Tensor:
    edges = bin_edges(lo, hi, num_bins)[1:-1].astype(np.float32)
    bits = edges.view(np.int32)[:, None] + np.arange(-ulps, ulps + 1, dtype=np.int32)[None, :]
    return torch.from_numpy(np.unique(bits.ravel()).view(np.float32))


def _specials(lo, hi) -> torch.Tensor:
    f32 = np.float32
    below_hi = np.nextafter(f32(hi), f32(0))
    return torch.tensor([0.0, -0.0, -1.0, -1e30, 1e-45, 1e-40, 1.1754942e-38, lo, hi, below_hi,
                         np.nextafter(f32(lo), f32(0)), np.nextafter(f32(hi), f32(np.inf)),
                         float("inf"), float("-inf"), float("nan"), 3.4028235e38],
                        dtype=torch.float32)


@pytest.mark.parametrize("lo,hi,num_bins", RULES)
def test_thresholds_are_sorted_and_lie_in_lo_hi(lo, hi, num_bins):
    e = bin_thresholds(lo, hi, num_bins)
    lo32, hi32 = (float(np.float32(v)) for v in (lo, hi))
    assert e.shape == (num_bins - 1,) and e.dtype == torch.float32
    assert float(e[0]) == lo32 and float(e[-1]) <= hi32
    assert bool((e[1:] >= e[:-1]).all())
    # Each is the least f32 of its bin: the float below it bins lower.
    below = torch.from_numpy(np.nextafter(e.numpy(), np.float32(0)))
    k = torch.arange(1, num_bins, dtype=torch.int32)
    assert bool((bin_index(e, lo, hi, num_bins) >= k).all())
    assert bool((bin_index(below, lo, hi, num_bins) < k).all())


@pytest.mark.parametrize("lo,hi,num_bins", RULES)
@pytest.mark.parametrize("where", ["near_edges", "log_uniform", "specials"])
def test_threshold_count_equals_bin_index(lo, hi, num_bins, where):
    if where == "near_edges":
        lat = _near_edges(lo, hi, num_bins)
    elif where == "log_uniform":
        rng = np.random.default_rng(num_bins)
        lat = torch.from_numpy(
            np.exp(rng.uniform(np.log(lo / 10), np.log(hi * 10), 1_000_000)).astype(np.float32))
    else:
        lat = _specials(lo, hi)
    e = bin_thresholds(lo, hi, num_bins)
    assert torch.equal(_count(lat, e, lo, hi, num_bins), bin_index(lat, lo, hi, num_bins))
