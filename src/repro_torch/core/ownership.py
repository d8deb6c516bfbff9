"""Ownership coefficient — the heart of Redynis (paper §6.1), in PyTorch
(counterpart of ``src/repro/core/ownership.py``).

For an object ``O`` and node ``x``: ``f(O, x) = g(O, x) / g(O, all)``
(eq. 1); node ``x`` is entitled to a replica iff ``f(O, x) >= H`` (eq. 2),
under the starvation-avoidance constraint ``H <= 1/n`` (eq. 3).
"""

from __future__ import annotations

import torch

__all__ = [
    "validate_coefficient",
    "max_coefficient",
    "ownership_fraction",
    "eligible_hosts",
    "eligible_from_fractions",
]


def validate_coefficient(h: float, n_nodes: int) -> None:
    """Enforce the paper's eq. 3 constraint ``H <= 1/n`` (host-side check)."""
    if n_nodes <= 0:
        raise ValueError(f"n_nodes must be positive, got {n_nodes}")
    if not (0.0 < h <= 1.0 / n_nodes + 1e-12):
        raise ValueError(
            f"ownership coefficient H={h} violates 0 < H <= 1/n "
            f"(n={n_nodes}, 1/n={1.0 / n_nodes:.6f}); see paper eq. 3"
        )


def max_coefficient(n_nodes: int) -> float:
    """Largest admissible H for an ``n_nodes`` cluster (= 1/n)."""
    return 1.0 / n_nodes


def ownership_fraction(counts: torch.Tensor) -> torch.Tensor:
    """Eq. 1 in f32, with ``f = 0`` where the object was never accessed.

    The row total is added left to right, the order of the CUDA kernel and
    of XLA-CPU's short-row sums: with fractional (EMA) counts a reordered
    sum moves ``f`` by an ulp and can flip ``f >= H`` at the boundary."""
    counts = counts.to(torch.float32)
    total = counts[..., :1]
    for j in range(1, counts.shape[-1]):
        total = total + counts[..., j : j + 1]
    return torch.where(
        total > 0, counts / torch.clamp_min(total, 1.0), torch.zeros_like(counts)
    )


def eligible_hosts(counts: torch.Tensor, h: float) -> torch.Tensor:
    """Eq. 2: ``[..., N]`` bool mask of nodes with ``f >= H``, with the
    starvation guard (traffic but nobody qualifies -> first argmax node)."""
    return eligible_from_fractions(ownership_fraction(counts), counts, h)


def eligible_from_fractions(f: torch.Tensor, counts: torch.Tensor, h: float) -> torch.Tensor:
    """Eligibility from precomputed fractions; ``H`` is compared in f32."""
    mask = f >= torch.full((), h, dtype=f.dtype, device=f.device)
    counts = counts.to(torch.float32)
    has_traffic = counts.sum(dim=-1) > 0
    none_qualify = has_traffic & ~mask.any(dim=-1)
    # First index of the maximum, as jnp.argmax breaks ties.
    n = counts.shape[-1]
    idx = torch.arange(n, device=counts.device)
    is_max = counts == counts.amax(dim=-1, keepdim=True)
    first = torch.where(is_max, idx, n).amin(dim=-1)
    fallback = idx == first[..., None]
    return torch.where(none_qualify[..., None], fallback, mask)
