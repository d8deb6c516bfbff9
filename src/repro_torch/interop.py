"""Carry the reference package's state across as numpy arrays.

The JAX package and this one never import each other; a caller that holds
both (the parity tests) converts the reference's arrays with ``np.asarray``
and hands them here, so both engines see identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.metadata import MetadataStore
from repro_torch.device import resolve_device
from repro_torch.kvsim.cluster import ClusterConfig
from repro_torch.kvsim.workload import Trace

__all__ = ["trace_from_numpy", "store_from_numpy", "cluster_from_fields"]


def _t(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def trace_from_numpy(keys, nodes, is_read, natural_node, object_bytes, device=None) -> Trace:
    """A ``Trace`` of the port from the five reference trace arrays, on
    ``device`` (``None`` means CUDA; see ``device.resolve_device``)."""
    device = resolve_device(device)
    return Trace(
        keys=_t(keys, torch.int32, device),
        nodes=_t(nodes, torch.int32, device),
        is_read=_t(is_read, torch.bool, device),
        natural_node=_t(natural_node, torch.int32, device),
        object_bytes=_t(object_bytes, torch.float32, device),
    )


def store_from_numpy(access_counts, hosts, last_access, live, home, device=None) -> MetadataStore:
    """A ``MetadataStore`` of the port from the reference's five arrays, on
    ``device`` (``None`` means CUDA)."""
    device = resolve_device(device)
    return MetadataStore(
        access_counts=_t(access_counts, torch.int32, device),
        hosts=_t(hosts, torch.bool, device),
        last_access=_t(last_access, torch.int32, device),
        live=_t(live, torch.bool, device),
        home=_t(home, torch.int32, device),
    )


def cluster_from_fields(**fields) -> ClusterConfig:
    """A ``ClusterConfig`` from a reference config's ``_asdict()``. Fields
    this slice does not cover (queueing, routing, failure injection, node
    labels) must be unset."""
    for name in ("service", "routing", "faults", "zone_of", "region_of"):
        if fields.get(name) is not None:
            raise NotImplementedError(
                f"cluster_from_fields: ClusterConfig.{name} is not ported yet"
            )
    return ClusterConfig(**fields)
