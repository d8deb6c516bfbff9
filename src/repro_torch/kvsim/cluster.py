"""Cluster latency model configuration (paper §8.2, generalised to an
``[N, N]`` RTT matrix) — the PyTorch counterpart of ``src/repro/kvsim/cluster.py``.

The paper's 3-node testbed is the degenerate flat topology (``local_ms`` on
the diagonal, ``remote_ms`` everywhere else) and is the default
(``rtt=None``); ``wan5_cluster`` is the 5-region WAN preset. The latency
functions themselves live in ``repro_torch.kernels.chunk_replay.ref``.

``ClusterConfig`` keeps every field of the reference, defaults included, so
a reference config converts field by field (``interop.cluster_from_fields``).
The queueing (``service``), routing (``routing``), failure-injection
(``faults``, ``zone_of``, ``region_of``) and finite-capacity fields are
accepted here but rejected by ``run_scenario`` until their slices land.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = [
    "ClusterConfig",
    "flat_rtt",
    "wan5_cluster",
    "WAN5_REGIONS",
    "WAN5_RTT_MS",
]


def flat_rtt(
    num_nodes: int = 3, remote_ms: float = 100.0, local_ms: float = 0.0
) -> tuple[tuple[float, ...], ...]:
    """The paper's testbed topology: a uniform ``remote_ms`` between every
    pair of distinct nodes."""
    return tuple(
        tuple(local_ms if i == j else remote_ms for j in range(num_nodes))
        for i in range(num_nodes)
    )


# 5-region WAN preset: approximate public-cloud inter-region RTTs in ms.
WAN5_REGIONS = ("us-east", "us-west", "eu-west", "ap-southeast", "ap-northeast")
WAN5_RTT_MS: tuple[tuple[float, ...], ...] = (
    (0.0, 65.0, 75.0, 230.0, 170.0),
    (65.0, 0.0, 140.0, 165.0, 105.0),
    (75.0, 140.0, 0.0, 160.0, 220.0),
    (230.0, 165.0, 160.0, 0.0, 70.0),
    (170.0, 105.0, 220.0, 70.0, 0.0),
)


class ClusterConfig(NamedTuple):
    num_nodes: int = 3  # paper: 3-node testbed
    remote_ms: float = 100.0  # paper: simulated geo-distributed RTT
    local_ms: float = 0.0
    service_ms: float = 10.0  # per-op service cost (calibration constant)
    master: int = 0  # master propagator (write serializer)
    value_bytes: float = 1024.0
    key_bytes: float = 16.0
    # [N][N] pairwise RTT in ms; None -> the flat topology.
    rtt: tuple[tuple[float, ...], ...] | None = None
    # Size-aware per-key transfer cost on remote hops; 0 = pure-RTT model.
    transfer_ms_per_kb: float = 0.0
    # Per-node replica-byte budget (scalar or [N] tuple); inf = Algorithm 3.
    capacity_bytes: tuple[float, ...] | float = float("inf")
    # Later slices: queueing model, routing tier, failure injection.
    service: Any = None
    routing: Any = None
    zone_of: tuple[int, ...] | None = None
    region_of: tuple[int, ...] | None = None
    faults: Any = None

    def rtt_matrix(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The ``[N, N]`` f32 RTT matrix on ``device`` (``None`` means CUDA)."""
        rows = (
            flat_rtt(self.num_nodes, self.remote_ms, self.local_ms)
            if self.rtt is None
            else self.rtt
        )
        return torch.tensor(rows, dtype=torch.float32, device=resolve_device(device))

    def transfer_ms(self, payload_bytes: float | None = None) -> float:
        """Payload serialisation/transfer time for one remote hop."""
        if payload_bytes is None:
            payload_bytes = self.value_bytes
        return self.transfer_ms_per_kb * (payload_bytes / 1024.0)

    def capacity_tuple(self) -> tuple[float, ...]:
        """Per-node budgets as an ``[N]`` tuple (scalar broadcast)."""
        if isinstance(self.capacity_bytes, tuple):
            return tuple(float(c) for c in self.capacity_bytes)
        return (float(self.capacity_bytes),) * self.num_nodes

    @property
    def has_finite_capacity(self) -> bool:
        return any(math.isfinite(c) for c in self.capacity_tuple())


def wan5_cluster(service_ms: float = 10.0, **kwargs) -> ClusterConfig:
    """5-region WAN preset (``WAN5_REGIONS`` RTTs), master in us-east."""
    return ClusterConfig(
        num_nodes=5, rtt=WAN5_RTT_MS, service_ms=service_ms, **kwargs
    )
