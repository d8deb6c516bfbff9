"""Repartition execution: a ``PlacementPlan`` turned into scheduled data
moves (counterpart of ``src/repro/core/repartition.py``).

The paper's daemon enforces placement changes with per-key RPCs. Here the
payloads are tensors and the transport a collective: each sweep publishes
the objects that gained replicas with one fused ``all_reduce`` over the
ranks (``spmd``), then every rank copies the slots it now owns into its
fixed-size replica cache.

The paper's two properties hold:

  * **non-blocking**: the plan is computed by the sweep and committed at a
    step boundary; until the commit, consumers read the previous replica
    map (``CommitState``'s double buffer);
  * **bounded memory**: the cache has a fixed slot count, and the plans are
    post-projection (the sweep's capacity stage already evicted what does
    not fit a node's byte budget); ``Moves.slot_bytes`` reports each rank's
    cache residency.

``group=None`` is the one-process program (the reference's
``axis_name=None``); with a ``torch.distributed`` group the publish buffer
is the sum of every rank's contribution.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.placement import PlacementPlan
from repro_torch.device import resolve_device
from repro_torch.spmd import all_sum

__all__ = [
    "ReplicaCache",
    "create_cache",
    "plan_moves",
    "publish_and_fill",
    "CommitState",
]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first ``True`` along the last axis (0 where none is),
    as ``jnp.argmax`` gives on a bool mask."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


class ReplicaCache(NamedTuple):
    """Fixed-capacity per-rank replica store of K-object state.

    ids:  [C] int32, the object id held in each slot (-1 = empty)
    data: [C, ...] payloads
    """

    ids: torch.Tensor
    data: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.ids.shape[0]

    def lookup(self, object_id: torch.Tensor) -> torch.Tensor:
        """Slot index holding ``object_id`` (any shape) or -1, int32."""
        hit = self.ids == object_id[..., None]
        return torch.where(hit.any(dim=-1), _first_true(hit), -1).to(torch.int32)


def create_cache(capacity: int, payload_shape: tuple, dtype=torch.float32,
                 device: str | torch.device | None = None) -> ReplicaCache:
    """An empty cache on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    return ReplicaCache(
        ids=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        data=torch.zeros((capacity, *payload_shape), dtype=dtype, device=dev),
    )


class Moves(NamedTuple):
    """Static-shape move schedule of one sweep (padded to ``max_moves``)."""

    publish_ids: torch.Tensor  # [M] int32 object ids this sweep publishes (-1 pad)
    slot_ids: torch.Tensor  # [N, C] int32 desired cache contents per rank (-1 empty)
    moved_bytes: torch.Tensor  # [] f32 bytes the fused publish carries
    slot_bytes: torch.Tensor  # [N] f32 bytes resident in each rank's cache after the move


def plan_moves(
    plan: PlacementPlan,
    home: torch.Tensor,  # [K] int home rank of each object
    cache_capacity: int,
    max_moves: int,
    object_bytes: torch.Tensor | float,
    priority: torch.Tensor | None = None,  # [K] float; higher = kept first
) -> Moves:
    """A ``PlacementPlan`` compiled into a static-shape move schedule.

    Rank ``n`` caches the objects with ``owners[k, n] & (home[k] != n)``,
    cut to ``cache_capacity``: with ``priority`` the hottest first (ties by
    object id: a stable sort of ``-priority``), else in id order. The
    published objects are those that any rank adds, in id order, cut to
    ``max_moves``. The byte totals are f64 sums rounded once."""
    owners = plan.owners
    k, n = owners.shape
    dev = owners.device
    arange_k = torch.arange(k, dtype=torch.int64, device=dev)
    obj_k = torch.as_tensor(object_bytes, dtype=torch.float32, device=dev).expand(k)
    if priority is None:
        rank = arange_k
    else:
        pos = torch.argsort(-priority.to(torch.float32), stable=True)
        rank = torch.empty_like(arange_k).scatter_(0, pos, arange_k)

    want = owners & (home.long()[:, None] != torch.arange(n, device=dev)[None, :])  # [K, N]
    score = torch.where(want.T, rank[None, :], k)  # [N, K]; unwanted sorts last
    order = torch.argsort(score, dim=1, stable=True)[:, :cache_capacity]
    slot_ids = torch.where(torch.gather(score, 1, order) < k, order, -1).to(torch.int32)

    added_any = plan.to_add.any(dim=-1)
    pub = torch.sort(torch.where(added_any, arange_k, k)).values[:max_moves]
    publish_ids = torch.where(pub < k, pub, -1).to(torch.int32)

    zero = torch.zeros((), dtype=torch.float64, device=dev)
    obj64 = obj_k.double()
    moved_bytes = torch.where(added_any, obj64, zero).sum().float()
    slot_bytes = torch.where(slot_ids >= 0, obj64[slot_ids.long().clamp_min(0)], zero).sum(dim=-1)
    return Moves(publish_ids=publish_ids, slot_ids=slot_ids, moved_bytes=moved_bytes,
                 slot_bytes=slot_bytes.float())


def publish_and_fill(
    cache: ReplicaCache,
    moves: Moves,
    local_objects: torch.Tensor,  # [K_local, ...] this rank's home shard
    local_ids: torch.Tensor,  # [K_local] global object ids of the home shard
    rank: torch.Tensor | int,
    group=None,
) -> ReplicaCache:
    """One sweep's moves: every rank contributes the published objects it
    homes (zeros elsewhere), one ``all_reduce(SUM)`` over ``group`` makes
    the publish buffer on every rank (exactly one rank homes an object, so
    the sum is a broadcast, and exact), and each rank refreshes its slots.
    With ``group=None`` the publish buffer is the rank's own contribution.

    A slot whose desired object was just published takes the new data; a
    slot whose desired object the cache already holds keeps it; any other
    slot is emptied."""
    m = moves.publish_ids.shape[0]
    payload_shape = local_objects.shape[1:]
    expand = (1,) * len(payload_shape)
    zero = torch.zeros((), dtype=local_objects.dtype, device=local_objects.device)

    eq = moves.publish_ids[:, None] == local_ids[None, :]  # [M, K_local]
    have = eq.any(dim=-1)
    contrib = torch.where(have.view(m, *expand), local_objects[_first_true(eq)], zero)
    publish = all_sum(contrib, group)

    desired = moves.slot_ids[rank] if moves.slot_ids.ndim == 2 else moves.slot_ids
    c = cache.capacity
    pub_hit = desired[:, None] == moves.publish_ids[None, :]  # [C, M]
    from_pub = pub_hit.any(dim=-1) & (desired >= 0)
    old_hit = desired[:, None] == cache.ids[None, :]  # [C, C]
    from_old = old_hit.any(dim=-1) & (desired >= 0) & ~from_pub

    kept = torch.where(from_old.view(c, *expand), cache.data[_first_true(old_hit)],
                       torch.zeros((), dtype=cache.data.dtype, device=cache.data.device))
    data = torch.where(from_pub.view(c, *expand), publish[_first_true(pub_hit)].to(cache.data.dtype),
                       kept)
    ids = torch.where(from_pub | from_old, desired, -1).to(torch.int32)
    return ReplicaCache(ids=ids, data=data)


class CommitState(NamedTuple):
    """Double-buffered replica map: consumers read ``active`` while the
    daemon prepares ``staged``; ``commit`` flips at a step boundary."""

    active: ReplicaCache
    staged: ReplicaCache

    @staticmethod
    def create(cache: ReplicaCache) -> "CommitState":
        return CommitState(active=cache, staged=cache)

    def stage(self, new: ReplicaCache) -> "CommitState":
        return self._replace(staged=new)

    def commit(self) -> "CommitState":
        return CommitState(active=self.staged, staged=self.staged)
