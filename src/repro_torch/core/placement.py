"""Placement plan types and Algorithm 3's candidate set (counterpart of
``src/repro/core/placement.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.metadata import MetadataStore
from repro_torch.core.ownership import eligible_from_fractions

__all__ = ["PlacementPlan", "SweepStats", "redynis_candidates"]


class PlacementPlan(NamedTuple):
    """Output of one analysis pass (Algorithm 3 steps 1-3)."""

    owners: torch.Tensor  # [K, N] bool  -- post-sweep replica set
    to_add: torch.Tensor  # [K, N] bool  -- owners - current
    to_drop: torch.Tensor  # [K, N] bool -- current - owners
    expired: torch.Tensor  # [K]   bool  -- keys past expiry
    f: torch.Tensor | None = None  # [K, N] f32 ownership fractions
    capacity_evicted: torch.Tensor | None = None  # [K, N] bool


class SweepStats(NamedTuple):
    """Move accounting for one daemon step (0-dim int64 device tensors)."""

    adds: torch.Tensor  # replicas created
    drops: torch.Tensor  # replicas dropped (threshold + expiry)
    expiry_evictions: torch.Tensor  # drops attributable to key expiry
    capacity_evictions: torch.Tensor  # held replicas evicted by a budget


def redynis_candidates(store: MetadataStore, f: torch.Tensor, h: float) -> torch.Tensor:
    """Algorithm 3's candidate replica set from precomputed fractions:
    eligibility (eq. 2 + starvation guard), silence keeps the current
    placement, dead keys own nothing."""
    counts, hosts, live = store.access_counts, store.hosts, store.live
    eligible = eligible_from_fractions(f, counts, h)
    touched = counts.sum(dim=-1) > 0
    owners = torch.where(touched[:, None], eligible, hosts)
    return owners & live[:, None]
