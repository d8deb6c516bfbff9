"""Carry the reference package's state across as numpy arrays.

The JAX package and this one never import each other; a caller that holds
both (the parity tests) converts the reference's arrays with ``np.asarray``
and hands them here, so both engines see identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.expert_placement import ExpertPlacementState
from repro_torch.core.hot_embedding import HotEmbeddingState
from repro_torch.core.metadata import MetadataStore
from repro_torch.device import resolve_device
from repro_torch.kvsim.cluster import ClusterConfig, ServiceConfig
from repro_torch.kvsim.telemetry import TelemetryConfig
from repro_torch.kvsim.workload import Trace

__all__ = [
    "trace_from_numpy",
    "store_from_numpy",
    "cluster_from_fields",
    "telemetry_from_fields",
    "params_from_numpy",
    "expert_state_from_numpy",
    "hot_embedding_state_from_numpy",
]


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
    """A ``ClusterConfig`` from a reference config's ``_asdict()``. A
    reference ``ServiceConfig`` carries across by its fields; the fields
    this slice does not cover (routing, failure injection, node labels)
    must be unset."""
    for name in ("routing", "faults", "zone_of", "region_of"):
        if fields.get(name) is not None:
            raise NotImplementedError(
                f"cluster_from_fields: ClusterConfig.{name} is not ported yet"
            )
    service = fields.get("service")
    if service is not None:
        fields["service"] = ServiceConfig(**service._asdict())
    return ClusterConfig(**fields)


def telemetry_from_fields(**fields) -> TelemetryConfig:
    """A ``TelemetryConfig`` from a reference config's ``_asdict()``. The
    attribution and flight-recorder sub-configs carry across as they are:
    ``run_scenario`` raises while one is enabled (a later slice)."""
    return TelemetryConfig(**fields)


def _leaf_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits as uint16
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device=None):
    """A reference params tree (nested dicts of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as torch tensors with the same
    keys and dtypes on ``device`` (``None`` means CUDA). bf16 leaves carry
    across bit for bit."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_numpy(val, device) for key, val in tree.items()}
    return _leaf_from_numpy(tree, device)


def expert_state_from_numpy(counts, hot_ids, step, sweeps, moved, device=None) -> ExpertPlacementState:
    """An ``ExpertPlacementState`` from the reference state's five arrays."""
    device = resolve_device(device)
    return ExpertPlacementState(
        counts=_t(counts, torch.float32, device),
        hot_ids=_t(hot_ids, torch.int32, device),
        step=_t(step, torch.int32, device),
        sweeps=_t(sweeps, torch.int32, device),
        moved=_t(moved, torch.float32, device),
    )


def hot_embedding_state_from_numpy(counts, hot_ids, slot_map, sweeps, device=None) -> HotEmbeddingState:
    """A ``HotEmbeddingState`` from the reference state's four arrays."""
    device = resolve_device(device)
    return HotEmbeddingState(
        counts=_t(counts, torch.float32, device),
        hot_ids=_t(hot_ids, torch.int32, device),
        slot_map=_t(slot_map, torch.int32, device),
        sweeps=_t(sweeps, torch.int32, device),
    )
