"""Carry the reference package's state across as numpy arrays.

The JAX package and this one never import each other; a caller that holds
both (the parity tests) converts the reference's arrays with ``np.asarray``
and hands them here, so both engines see identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core.expert_placement import ExpertPlacementState
from repro_torch.core.hot_embedding import HotEmbeddingState
from repro_torch.core.metadata import MetadataStore
from repro_torch.device import resolve_device
from repro_torch.kvsim.cluster import ClusterConfig, ServiceConfig
from repro_torch.kvsim.faults import FaultConfig, FaultEvent
from repro_torch.kvsim.routing import RoutingConfig
from repro_torch.kvsim.telemetry import AttributionConfig, FlightRecorderConfig, TelemetryConfig
from repro_torch.kvsim.workload import Trace
from repro_torch.models.encdec import EncDecState
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.rwkv6 import RWKVState
from repro_torch.models.transformer import KVCache
from repro_torch.train.optim import OptState
from repro_torch.train.trainer import TrainState

__all__ = [
    "trace_from_numpy",
    "store_from_numpy",
    "cluster_from_fields",
    "telemetry_from_fields",
    "params_from_numpy",
    "expert_state_from_numpy",
    "hot_embedding_state_from_numpy",
    "kv_cache_from_numpy",
    "rwkv_state_from_numpy",
    "rglru_state_from_numpy",
    "encdec_state_from_numpy",
    "opt_state_from_numpy",
    "train_state_from_numpy",
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
    """A ``ClusterConfig`` from a reference config's ``_asdict()``. The
    reference's ``ServiceConfig``, ``RoutingConfig`` and ``FaultConfig`` (with
    its ``FaultEvent``\\ s) carry across by their fields, the ``zone_of`` and
    ``region_of`` labels as tuples. A field the port's ``ClusterConfig`` does
    not have raises ``NotImplementedError`` naming it."""
    uncovered = sorted(set(fields) - set(ClusterConfig._fields))
    if uncovered:
        raise NotImplementedError(
            f"cluster_from_fields: ClusterConfig.{', '.join(uncovered)} is not ported"
        )
    service, routing, faults = (fields.get(name) for name in ("service", "routing", "faults"))
    if service is not None:
        fields["service"] = ServiceConfig(**service._asdict())
    if routing is not None:
        fields["routing"] = RoutingConfig(**routing._asdict())
    if faults is not None:
        fields["faults"] = FaultConfig(
            enabled=faults.enabled,
            events=tuple(FaultEvent(**event._asdict()) for event in faults.events),
        )
    for name in ("zone_of", "region_of"):
        if fields.get(name) is not None:
            fields[name] = tuple(int(x) for x in fields[name])
    return ClusterConfig(**fields)


def telemetry_from_fields(**fields) -> TelemetryConfig:
    """A ``TelemetryConfig`` from a reference config's ``_asdict()``; its
    ``AttributionConfig`` and ``FlightRecorderConfig`` carry across by their
    fields."""
    for name, cls in (("attribution", AttributionConfig), ("flight", FlightRecorderConfig)):
        if fields.get(name) is not None:
            fields[name] = cls(**fields[name]._asdict())
    return TelemetryConfig(**fields)


def _leaf_from_numpy(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits as uint16
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device=None):
    """A reference params tree (nested dicts and lists of arrays, e.g.
    ``jax.tree.map(np.asarray, params)``; rglru keeps per-layer lists) as
    torch tensors with the same structure and dtypes on ``device``
    (``None`` means CUDA). bf16 leaves carry across bit for bit; an int8
    tree's ``{"q", "s"}`` leaves carry across as such."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {key: params_from_numpy(val, device) for key, val in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(val, device) for val in tree)
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


def kv_cache_from_numpy(k, v, length, device=None) -> KVCache:
    """A ``KVCache`` from a reference decode state's three arrays (k and v
    ``[L, B, T, KH, Dh]``, bf16 bit for bit; length ``[B]`` int32)."""
    device = resolve_device(device)
    return KVCache(k=_leaf_from_numpy(k, device), v=_leaf_from_numpy(v, device),
                   length=_t(length, torch.int32, device))


def rwkv_state_from_numpy(x_tm, x_cm, wkv, device=None) -> RWKVState:
    """An ``RWKVState`` from the reference's three arrays (``x_tm``, ``x_cm``
    ``[L, B, D]`` bf16 bit for bit, ``wkv [L, B, H, Dh, Dh]`` f32)."""
    device = resolve_device(device)
    return RWKVState(x_tm=_leaf_from_numpy(x_tm, device), x_cm=_leaf_from_numpy(x_cm, device),
                     wkv=_t(wkv, torch.float32, device))


def rglru_state_from_numpy(conv, h, caches, length, device=None) -> RGLRUState:
    """An ``RGLRUState`` from the reference's fields: the per-recurrent-layer
    lists ``conv`` (bf16) and ``h`` (f32), the per-attention-layer list of
    ``(k, v)`` ring buffers (bf16) and ``length [B]`` int32."""
    device = resolve_device(device)
    return RGLRUState(
        conv=[_leaf_from_numpy(c, device) for c in conv],
        h=[_t(x, torch.float32, device) for x in h],
        caches=[(_leaf_from_numpy(k, device), _leaf_from_numpy(v, device)) for k, v in caches],
        length=_t(length, torch.int32, device),
    )


def encdec_state_from_numpy(self_k, self_v, cross_k, cross_v, length, device=None) -> EncDecState:
    """An ``EncDecState`` from the reference's five arrays (the caches ``[L,
    B, ., KH, Dh]`` bf16 bit for bit, ``length [B]`` int32)."""
    device = resolve_device(device)
    return EncDecState(*(_leaf_from_numpy(a, device) for a in (self_k, self_v, cross_k, cross_v)),
                       length=_t(length, torch.int32, device))


def opt_state_from_numpy(m, v, step, device=None) -> OptState:
    """An ``OptState`` from the reference's (``m`` and ``v`` trees of f32
    arrays, ``step`` an int32 scalar), e.g. ``jax.tree.map(np.asarray,
    opt)``'s fields."""
    device = resolve_device(device)
    return OptState(m=params_from_numpy(m, device), v=params_from_numpy(v, device),
                    step=_t(step, torch.int32, device))


def train_state_from_numpy(params, opt, expert_placement=None, hot_embed=None, data_step: int = 0,
                           device=None) -> TrainState:
    """A ``TrainState`` from the reference's fields as numpy: ``params`` a
    tree, ``opt`` a ``(m, v, step)`` triple (the reference's ``OptState``
    fields), ``expert_placement`` and ``hot_embed`` the daemon states'
    fields in order or ``None``. The params require grad, as
    ``Trainer.init_state`` makes them."""
    device = resolve_device(device)
    tparams = params_from_numpy(params, device)
    for leaf in tree_lib.leaves(tparams):
        leaf.requires_grad_(True)
    return TrainState(
        params=tparams,
        opt=opt_state_from_numpy(*opt, device=device),
        expert_placement=None if expert_placement is None
        else expert_state_from_numpy(*expert_placement, device=device),
        hot_embed=None if hot_embed is None else hot_embedding_state_from_numpy(*hot_embed, device=device),
        data_step=int(data_step),
    )
