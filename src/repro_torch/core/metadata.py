"""Key metadata store — the paper's metadata layer (§6.2) as dense tensors
(counterpart of ``src/repro/core/metadata.py``).

    access_counts [K, N] int32   -- hostAccesses  (g(O, x))
    hosts         [K, N] bool    -- replica set
    last_access   [K]    int32   -- lastAccessedDate, in ticks
    live          [K]    bool    -- key exists
    home          [K]    int32   -- node that first stored the key

Unlike the reference's immutable arrays, ``record_accesses`` folds a batch
into the store's tensors in place (the engine owns the store, and a
``[K, N]`` copy per chunk would double its memory traffic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = ["MetadataStore", "create_store", "record_accesses"]

_INT32_MIN = -(2**31)


class MetadataStore(NamedTuple):
    """Dense metadata for K keys × N nodes (paper §6.2, vectorised)."""

    access_counts: torch.Tensor  # [K, N] int32
    hosts: torch.Tensor  # [K, N] bool
    last_access: torch.Tensor  # [K] int32 ticks
    live: torch.Tensor  # [K] bool
    home: torch.Tensor  # [K] int32

    @property
    def num_keys(self) -> int:
        return self.access_counts.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.access_counts.shape[1]


def create_store(
    num_keys: int, num_nodes: int, device: str | torch.device | None = None
) -> MetadataStore:
    """Empty metadata cluster for a fixed key universe, on ``device``
    (``None`` means CUDA; see ``device.resolve_device``)."""
    device = resolve_device(device)
    return MetadataStore(
        access_counts=torch.zeros((num_keys, num_nodes), dtype=torch.int32, device=device),
        hosts=torch.zeros((num_keys, num_nodes), dtype=torch.bool, device=device),
        last_access=torch.zeros(num_keys, dtype=torch.int32, device=device),
        live=torch.zeros(num_keys, dtype=torch.bool, device=device),
        home=torch.zeros(num_keys, dtype=torch.int32, device=device),
    )


def record_accesses(
    store: MetadataStore,
    keys: torch.Tensor,  # [B] int
    nodes: torch.Tensor,  # [B] int
    now: int,
    valid: torch.Tensor | None = None,  # [B] bool; False rows are ignored
) -> MetadataStore:
    """Fold a batch of accesses into the store, in place, and return it.

    ``valid=False`` rows change neither counts nor ``last_access`` (the
    reference's ``mode="drop"``): they add a zero weight and offer the
    smallest int32 timestamp to the ``amax``, both no-ops, so the fold
    needs no host-side compaction.
    """
    n = store.num_nodes
    keys = keys.long()
    w = torch.ones_like(keys, dtype=torch.int32)
    stamp = torch.full_like(keys, int(now), dtype=torch.int32)
    if valid is not None:
        w = torch.where(valid, w, torch.zeros_like(w))
        stamp = torch.where(valid, stamp, torch.full_like(stamp, _INT32_MIN))
    flat = keys * n + nodes.long()
    store.access_counts.view(-1).index_put_((flat,), w, accumulate=True)
    store.last_access.scatter_reduce_(0, keys, stamp, reduce="amax")
    return store
