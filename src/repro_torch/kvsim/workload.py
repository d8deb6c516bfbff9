"""YCSB-style workload generation (paper §8.2) + geo workload presets — the
PyTorch counterpart of ``src/repro/kvsim/workload.py``.

``generate_trace`` draws the same distributions as the reference with an
explicit ``torch.Generator`` on the target device: the paper's two-tier
90/10 skew ("10% of the data items requested 90% of the time"), the per-key
natural request source (``region_weights`` through ``torch.multinomial``),
``affinity``, the diurnal rotation and ``read_fraction``. It does not give
the reference's threefry bits; a trace built elsewhere enters
``run_scenario`` through its ``trace=`` argument (``interop.trace_from_numpy``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = [
    "WorkloadConfig",
    "Trace",
    "generate_trace",
    "wan5_workload",
    "diurnal_workload",
]


class WorkloadConfig(NamedTuple):
    num_requests: int = 100_000  # paper: uniform set of 100k requests
    num_keys: int = 1_000  # 100 accesses/key under uniform traffic
    num_nodes: int = 3  # paper testbed: 3 nodes
    read_fraction: float = 1.0  # 1.0 .. 0.5
    skewed: bool = False  # False=uniform, True=zipfian 90/10
    hot_fraction: float = 0.10  # "10% of the data items ..."
    hot_traffic: float = 0.90  # "... 90% of the time"
    affinity: float = 1.0  # P(request arrives at the key's natural node)
    region_weights: tuple[float, ...] | None = None  # P(natural node = i)
    diurnal_shifts: int = 0  # >0: request sources rotate across the trace
    object_bytes: float = 1024.0
    object_bytes_sigma: float = 0.0  # lognormal per-key size spread


class Trace(NamedTuple):
    keys: torch.Tensor  # [R] int32
    nodes: torch.Tensor  # [R] int32 requesting node
    is_read: torch.Tensor  # [R] bool
    natural_node: torch.Tensor  # [K] int32 per-key natural source
    object_bytes: torch.Tensor  # [K] f32 per-key payload size

    def to(self, device: str | torch.device) -> "Trace":
        return Trace(*(t.to(device) for t in self))

    def cpu(self) -> "Trace":
        return self.to("cpu")


def _check_region_weights(cfg: WorkloadConfig) -> None:
    if cfg.region_weights is not None and len(cfg.region_weights) != cfg.num_nodes:
        raise ValueError(
            f"region_weights has {len(cfg.region_weights)} entries "
            f"for {cfg.num_nodes} nodes"
        )


def generate_trace(
    cfg: WorkloadConfig,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Trace:
    """A materialised ``[R]`` request trace drawn on ``device`` from
    ``seed`` (same distributions as the reference, not the same bits)."""
    _check_region_weights(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    r, k, n = cfg.num_requests, cfg.num_keys, cfg.num_nodes

    def uniform(size: int) -> torch.Tensor:
        return torch.rand(size, generator=gen, device=dev)

    def randint(low: int, high: int, size: int) -> torch.Tensor:
        return torch.randint(
            low, high, (size,), generator=gen, device=dev, dtype=torch.int32
        )

    if cfg.skewed:
        n_hot = max(1, int(k * cfg.hot_fraction))
        pick_hot = uniform(r) < cfg.hot_traffic
        hot_ids = randint(0, n_hot, r)
        cold_ids = randint(n_hot, k, r) if n_hot < k else hot_ids
        keys = torch.where(pick_hot, hot_ids, cold_ids)
    else:
        keys = randint(0, k, r)

    if cfg.region_weights is not None:
        w = torch.tensor(cfg.region_weights, dtype=torch.float32, device=dev)
        natural = torch.multinomial(
            w / w.sum(), k, replacement=True, generator=gen
        ).to(torch.int32)
    else:
        natural = randint(0, n, k)

    stay = uniform(r) < cfg.affinity
    # A non-natural request lands uniformly on one of the other n-1 nodes.
    shift = randint(1, n, r) if n > 1 else torch.zeros_like(keys)
    nat_of_key = natural[keys.long()]
    nodes = torch.where(stay, nat_of_key, (nat_of_key + shift) % n)

    if cfg.diurnal_shifts > 0:
        # "Follow the sun": phase p rotates every request source p nodes.
        phase = torch.arange(r, device=dev, dtype=torch.int64)
        phase = (phase * cfg.diurnal_shifts) // r
        nodes = (nodes + phase) % n

    if cfg.object_bytes_sigma > 0:
        sizes = cfg.object_bytes * torch.exp(
            cfg.object_bytes_sigma
            * torch.randn(k, generator=gen, device=dev)
        )
    else:
        sizes = torch.full((k,), cfg.object_bytes, device=dev)
    is_read = uniform(r) < cfg.read_fraction
    return Trace(
        keys=keys.to(torch.int32),
        nodes=nodes.to(torch.int32),
        is_read=is_read,
        natural_node=natural,
        object_bytes=sizes.to(torch.float32),
    )


def wan5_workload(**kwargs) -> WorkloadConfig:
    """5-region WAN preset: skewed traffic whose natural sources concentrate
    in two hot regions (pairs with ``cluster.wan5_cluster``)."""
    kwargs.setdefault("num_nodes", 5)
    kwargs.setdefault("skewed", True)
    kwargs.setdefault("region_weights", (0.35, 0.25, 0.20, 0.12, 0.08))
    return WorkloadConfig(**kwargs)


def diurnal_workload(**kwargs) -> WorkloadConfig:
    """Diurnal hot-region preset: traffic concentrated in one region whose
    identity rotates across the trace."""
    kwargs.setdefault("num_nodes", 5)
    kwargs.setdefault("skewed", True)
    kwargs.setdefault("region_weights", (0.60, 0.10, 0.10, 0.10, 0.10))
    kwargs.setdefault("diurnal_shifts", 4)
    return WorkloadConfig(**kwargs)
