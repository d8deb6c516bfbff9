"""Key metadata store — the paper's metadata layer (§6.2) as dense tensors
(counterpart of ``src/repro/core/metadata.py``).

    access_counts [K, N] int32   -- hostAccesses  (g(O, x))
    hosts         [K, N] bool    -- replica set
    last_access   [K]    int32   -- lastAccessedDate, in ticks
    live          [K]    bool    -- key exists
    home          [K]    int32   -- node that first stored the key

Unlike the reference's immutable arrays, ``record_accesses`` and
``record_new_keys`` fold a batch into the store's tensors in place (the
engine owns the store, and a ``[K, N]`` copy per chunk would double its
memory traffic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = [
    "MetadataStore",
    "create_store",
    "record_accesses",
    "record_new_keys",
    "local_hit",
    "owner_of",
]

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


def record_new_keys(
    store: MetadataStore,
    keys: torch.Tensor,  # [B] int
    nodes: torch.Tensor,  # [B] int
    now: int,
) -> MetadataStore:
    """Algorithm 1's 'metadata == null' branch, in place: a key not yet live
    is stored on the node that received the request (its home), and the
    access is logged. Existing keys are left untouched (masked), so a mixed
    batch is safe. Within one batch, a new key named twice takes one of its
    nodes as home, as the reference's scatter does."""
    keys, nodes = keys.long(), nodes.long()
    is_new = ~store.live[keys]
    store.hosts[keys, nodes] = store.hosts[keys, nodes] | is_new
    store.live[keys] = store.live[keys] | is_new
    store.home[keys] = torch.where(is_new, nodes.to(torch.int32), store.home[keys])
    return record_accesses(store, keys, nodes, now)


def local_hit(store: MetadataStore, keys: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """``[B]`` bool: does the requesting node hold a replica (Algorithm 1's test)?"""
    keys = keys.long()
    return store.hosts[keys, nodes.long()] & store.live[keys]


def owner_of(store: MetadataStore, keys: torch.Tensor) -> torch.Tensor:
    """``[B]`` int32 owner for a remote fetch: the home node if it still
    holds a replica, else the lowest-indexed holder (node 0 for a key with
    none, as the reference's argmax of an all-false row)."""
    keys = keys.long()
    home = store.home[keys].long()
    rows = store.hosts[keys]
    home_ok = rows.gather(1, home[:, None])[:, 0]
    n = store.num_nodes
    idx = torch.arange(n, device=rows.device)
    first = torch.where(rows, idx, n).amin(dim=-1) % n
    return torch.where(home_ok, home, first).to(torch.int32)
