"""Traffic statistics for ML-state objects (counterpart of
``src/repro/core/traffic.py``).

For ML state the access events are tokens of data-parallel group ``r``
routed to expert ``e`` (MoE), lookups of vocabulary row ``v`` by data shard
``r`` (embeddings), or requests for session ``s`` at pod ``p`` (serving).
All reduce to the ``[K, N]`` count matrix of the core engine, kept here in
f32 with an optional EMA decay so placement follows traffic shifts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = ["TrafficStats", "create_stats", "fold_counts", "fold_events", "decay_stats"]


class TrafficStats(NamedTuple):
    counts: torch.Tensor  # [K, N] f32 (EMA-decayed access counts g(O, x))
    last_access: torch.Tensor  # [K] int32 tick of last access
    total_events: torch.Tensor  # [] f32 running event count (diagnostics)

    @property
    def num_objects(self) -> int:
        return self.counts.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.counts.shape[1]


def create_stats(num_objects: int, num_nodes: int, device=None) -> TrafficStats:
    """Empty statistics on ``device`` (``None`` means CUDA)."""
    device = resolve_device(device)
    return TrafficStats(
        counts=torch.zeros((num_objects, num_nodes), dtype=torch.float32, device=device),
        last_access=torch.zeros(num_objects, dtype=torch.int32, device=device),
        total_events=torch.zeros((), dtype=torch.float32, device=device),
    )


def fold_counts(stats: TrafficStats, delta: torch.Tensor, now: int) -> TrafficStats:
    """Fold a dense ``[K, N]`` count delta (e.g. a routing histogram)."""
    delta = delta.to(torch.float32)
    touched = delta.sum(dim=-1) > 0
    now_t = torch.full((), int(now), dtype=torch.int32, device=delta.device)
    return TrafficStats(
        counts=stats.counts + delta,
        last_access=torch.where(touched, now_t, stats.last_access),
        total_events=stats.total_events + delta.sum(),
    )


def fold_events(
    stats: TrafficStats,
    objects: torch.Tensor,
    nodes: torch.Tensor,
    now: int,
    weights: torch.Tensor | None = None,
) -> TrafficStats:
    """Fold sparse access events ``(object_id, node_id)``, one add per event
    in event order (the reference's scatter-add); ids out of range are
    dropped."""
    k, n = stats.counts.shape
    if weights is None:
        weights = torch.ones(objects.shape, dtype=torch.float32, device=objects.device)
    weights = weights.to(torch.float32)
    objects, nodes = objects.long(), nodes.long()
    flat = objects * n + nodes
    ok = (flat >= 0) & (flat < k * n)
    counts = stats.counts.reshape(-1).clone()
    counts.index_put_((flat[ok],), weights[ok], accumulate=True)
    last = stats.last_access.clone()
    seen = (objects >= 0) & (objects < k)
    last.scatter_reduce_(
        0, objects[seen],
        torch.full(objects[seen].shape, int(now), dtype=torch.int32, device=objects.device),
        reduce="amax",
    )
    return TrafficStats(
        counts=counts.reshape(k, n),
        last_access=last,
        total_events=stats.total_events + weights.sum(),
    )


def decay_stats(stats: TrafficStats, decay: float) -> TrafficStats:
    """EMA decay (1.0 = the paper's raw counters, < 1 = reactive)."""
    return stats._replace(counts=stats.counts * decay)
