"""Cluster latency model configuration (paper §8.2, generalised to an
``[N, N]`` RTT matrix) — the PyTorch counterpart of ``src/repro/kvsim/cluster.py``.

The paper's 3-node testbed is the degenerate flat topology (``local_ms`` on
the diagonal, ``remote_ms`` everywhere else) and is the default
(``rtt=None``); ``wan5_cluster`` is the 5-region WAN preset. The latency
functions themselves live in ``repro_torch.kernels.chunk_replay.ref``.

``ClusterConfig`` keeps every field of the reference, defaults included, so
a reference config converts field by field (``interop.cluster_from_fields``).
``service`` takes a :class:`ServiceConfig` (the M/M/1 contention model) and
``capacity_bytes`` the per-node replica-byte budgets (``wan5_edge_cluster``
is the preset with one small edge node), ``routing`` a
:class:`~repro_torch.kvsim.routing.RoutingConfig` (the directory tier) and
``faults`` a :class:`~repro_torch.kvsim.faults.FaultConfig` (failure
injection), whose zone and region events target the nodes that
``zone_of`` / ``region_of`` label.
The flat (``read_latency``, ``write_latency``) and geo (``*_geo``,
``nearest_replica_rtt``) latency functions are the config-level spelling of
``kernels/chunk_replay/ref.py``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kvsim.faults import FaultConfig
from repro_torch.kvsim.routing import RoutingConfig
from repro_torch.kernels.chunk_replay.ref import (
    nearest_replica_rtt_ref,
    read_latency_ref,
    write_latency_ref,
)

__all__ = [
    "ClusterConfig",
    "ServiceConfig",
    "normalize_service",
    "flat_rtt",
    "wan5_cluster",
    "wan5_edge_cluster",
    "WAN5_REGIONS",
    "WAN5_RTT_MS",
    "read_latency",
    "write_latency",
    "nearest_replica_rtt",
    "read_latency_geo",
    "write_latency_geo",
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


class ServiceConfig(NamedTuple):
    """Queueing-aware service-time model (M/M/1 style). Per request the
    service demand is ``d = service_ms + object_bytes[key] /
    serve_bytes_per_ms``, folded per serving node over each chunk (reads
    are served by the nearest visible replica, writes by the requesting
    node). A node's load factor is ``rho = min(fold / capacity_ms,
    rho_max)`` with ``capacity_ms = capacity_factor * chunk_size *
    service_ms``, and each request waits ``d * rho / (1 - rho)`` on top of
    its RTT latency. The pre-pass is ``kernels.chunk_replay.ref
    .contention_extra_ms_ref``."""

    enabled: bool = True
    serve_bytes_per_ms: float = 1024.0  # node service bandwidth (bytes/ms)
    capacity_factor: float = 1.0  # node capacity per chunk, in chunks
    rho_max: float = 0.95  # stability clamp (must stay < 1)

    def validate(self) -> "ServiceConfig":
        if not self.serve_bytes_per_ms > 0:
            raise ValueError(
                f"serve_bytes_per_ms must be positive, got {self.serve_bytes_per_ms}"
            )
        if not self.capacity_factor > 0:
            raise ValueError(f"capacity_factor must be positive, got {self.capacity_factor}")
        if not 0.0 < self.rho_max < 1.0:
            raise ValueError(
                f"rho_max must lie in (0, 1) (the M/M/1 stability bound), got {self.rho_max}"
            )
        return self

    def capacity_ms(self, chunk_size: int, service_ms: float) -> float:
        """Per-node service capacity for one chunk, in ms of demand."""
        return self.capacity_factor * chunk_size * service_ms


def normalize_service(service: ServiceConfig | None) -> ServiceConfig | None:
    """``None`` and ``ServiceConfig(enabled=False)`` both mean no
    contention; an enabled config is validated."""
    if service is None or not service.enabled:
        return None
    return service.validate()


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
    # M/M/1 contention model (ServiceConfig); None = pure-RTT latency.
    service: ServiceConfig | None = None
    # Routing tier (RoutingConfig); None = requests know the live map.
    routing: RoutingConfig | None = None
    # Failure-domain labels: zone_of[n] / region_of[n]; None = each node
    # its own zone and region.
    zone_of: tuple[int, ...] | None = None
    region_of: tuple[int, ...] | None = None
    # Failure injection (FaultConfig); None = every node always up.
    faults: FaultConfig | None = None

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

    def capacity_vector(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The ``[N]`` f32 per-node budget on ``device`` (``None`` means CUDA)."""
        return torch.tensor(self.capacity_tuple(), dtype=torch.float32,
                            device=resolve_device(device))

    @property
    def has_finite_capacity(self) -> bool:
        return any(math.isfinite(c) for c in self.capacity_tuple())


def wan5_cluster(service_ms: float = 10.0, **kwargs) -> ClusterConfig:
    """5-region WAN preset (``WAN5_REGIONS`` RTTs), master in us-east."""
    return ClusterConfig(
        num_nodes=5, rtt=WAN5_RTT_MS, service_ms=service_ms, **kwargs
    )


def wan5_edge_cluster(
    edge_capacity_bytes: float = 64 * 1024.0, edge_node: int = 4, **kwargs
) -> ClusterConfig:
    """The 5-region WAN with one small edge node (default ap-northeast)
    whose replica budget is finite while the core regions are unbounded:
    the capacity projection evicts the edge node's coldest replicas."""
    caps = tuple(
        float(edge_capacity_bytes) if i == edge_node else float("inf") for i in range(5)
    )
    return wan5_cluster(capacity_bytes=caps, **kwargs)


# Flat-model latency functions (paper §8.2), for the degenerate topology.


def read_latency(cfg: ClusterConfig, hit: torch.Tensor) -> torch.Tensor:
    """Per-request read latency: service + RTT on a local miss (Algorithm 1)."""
    return torch.where(hit, cfg.local_ms, cfg.remote_ms) + cfg.service_ms


def write_latency(
    cfg: ClusterConfig,
    node: torch.Tensor,
    sole_local_owner: torch.Tensor,
    any_owner_remote_from_master: torch.Tensor,
) -> torch.Tensor:
    """Per-request write latency (Algorithm 2), flat topology: commit
    locally when the requesting node is the sole owner; otherwise relay to
    the master (RTT unless the requester is the master) and post to the
    owners (RTT if any owner is not the master)."""
    relay = torch.where(node == cfg.master, 0.0, cfg.remote_ms)
    post = torch.where(any_owner_remote_from_master, cfg.remote_ms, 0.0)
    return torch.where(sole_local_owner, 0.0, relay + post) + cfg.service_ms


# Geo latency functions over the [N, N] RTT matrix.


def nearest_replica_rtt(rtt: torch.Tensor, replicas: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """RTT from each requesting node to its nearest replica ``[B]``. An
    empty replica mask (reachable under a finite budget, which may evict a
    key's last replica) pays the topology's worst RTT: the backing-store
    fetch (in the flat testbed exactly ``remote_ms``)."""
    return nearest_replica_rtt_ref(rtt, replicas, nodes)


def read_latency_geo(cfg: ClusterConfig, rtt: torch.Tensor, replicas: torch.Tensor,
                     nodes: torch.Tensor) -> torch.Tensor:
    """Geo read path: service + RTT to the nearest replica, + the payload
    transfer charge when the requesting node holds no visible copy."""
    return read_latency_ref(rtt, replicas, nodes, service_ms=cfg.service_ms,
                            xfer_ms=cfg.transfer_ms(cfg.value_bytes))


def write_latency_geo(cfg: ClusterConfig, rtt: torch.Tensor, replicas: torch.Tensor,
                      nodes: torch.Tensor, sole_local_owner: torch.Tensor) -> torch.Tensor:
    """Geo write path (Algorithm 2 over the RTT matrix): relay to the
    master, then a parallel post completing at the farthest owner; a link
    crossing pays the transfer charge."""
    return write_latency_ref(rtt, replicas, nodes, sole_local_owner, service_ms=cfg.service_ms,
                             master=cfg.master,
                             xfer_ms=cfg.transfer_ms(cfg.value_bytes + cfg.key_bytes))
