"""Routing tier with a stale-directory cache (counterpart of
``src/repro/kvsim/routing.py``), as torch functions on the device of the
tensors they are given.

Router sites hold a bounded, popularity-aware cache of the ownership map;
directory updates publish ``publish_lag_chunks`` behind the placement
daemon, so a consult can hit a stale entry and pay a mis-route detour, or
miss and pay a directory fetch to ``home_node``
(``kernels.chunk_replay.ref.routing_extra_split_ref`` prices both):

  * **R router sites** (``RoutingConfig.num_routers``; 0 = one a node). A
    request from node ``x`` consults router ``x % R``.
  * **Bounded cache**: per router an ``[R, K]`` eligibility mask and the
    directory version each entry was last refreshed at. Admission is
    decay-LFU over the consult stream: per chunk ``score = score * decay +
    consults`` and the top ``cache_entries`` scores a router stay cached
    (ties at the threshold are all admitted). ``cache_entries = 0`` (or at
    least the keyspace) is the unbounded warm cache.
  * **Versioned publishes**: every placement commit bumps a per-key
    version (``core.policy.publish_mask``); the directory publishes through
    a ring of ``publish_lag_chunks + 1`` slots on the device, one slot read
    at chunk start and overwritten after the sweep, so routers see the map
    as it was L chunks ago.

Sharding (the reference's ``axis_name`` and its ``all_gather``) belongs to
the key-sharded engine and is not here.

Off by default: ``ClusterConfig.routing = None`` or
``RoutingConfig(enabled=False)`` (collapsed by :func:`normalize_routing`)
runs the engine without this tier.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.spmd import gather_ranks

__all__ = [
    "STALE_AGE_BINS",
    "RoutingConfig",
    "RouterState",
    "normalize_routing",
    "router_of",
    "init_router_state",
    "published_view",
    "consult_probe",
    "router_cache_update",
    "publish_commit",
    "stale_age_fold",
]

# Staleness-age histogram width: ages (authoritative version minus the
# version a consulted entry was refreshed at) in linear bins
# 0..STALE_AGE_BINS-2, the last bin absorbing everything older.
STALE_AGE_BINS = 16


class RoutingConfig(NamedTuple):
    """Directory/routing-tier knobs. Off at the cluster level by default
    (``routing=None``); a config turns the tier on unless ``enabled=False``."""

    enabled: bool = True
    num_routers: int = 0  # router sites; 0 = one per cluster node
    cache_entries: int = 0  # per-router cache capacity; 0 = unbounded/warm
    publish_lag_chunks: int = 0  # directory publish lag behind the daemon
    home_node: int = 0  # directory home (miss round-trip destination)
    decay: float = 1.0  # per-chunk decay of the LFU admission score

    def validate(self) -> "RoutingConfig":
        if self.num_routers < 0:
            raise ValueError(
                f"num_routers must be >= 0 (0 = one per node), got {self.num_routers}"
            )
        if self.cache_entries < 0:
            raise ValueError(
                f"cache_entries must be >= 0 (0 = unbounded), got {self.cache_entries}"
            )
        if self.publish_lag_chunks < 0:
            raise ValueError(
                f"publish_lag_chunks must be >= 0, got {self.publish_lag_chunks}"
            )
        if self.home_node < 0:
            raise ValueError(f"home_node must be a node index, got {self.home_node}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must lie in (0, 1], got {self.decay}")
        return self


def normalize_routing(routing: RoutingConfig | None) -> RoutingConfig | None:
    """``None`` and ``RoutingConfig(enabled=False)`` both mean no routing
    tier; an enabled config is validated."""
    if routing is None or not routing.enabled:
        return None
    return routing.validate()


class RouterState(NamedTuple):
    """The routing tier's state across chunks. ``None`` fields are absent:

      * ``cached``/``score`` for the unbounded warm cache;
      * ``ver`` under an inactive policy (a frozen map never publishes);
      * the ring at ``publish_lag_chunks == 0`` unless forced (faults).
    """

    cached: torch.Tensor | None  # [R, K] bool cache eligibility
    cached_ver: torch.Tensor  # [R, K] int32 version each entry was refreshed at
    score: torch.Tensor | None  # [R, K] f32 decay-LFU admission score
    ver: torch.Tensor | None  # [K] int32 authoritative per-key publish version
    ring_hosts: torch.Tensor | None  # [L+1, K, N] bool published-map ring
    ring_ver: torch.Tensor | None  # [L+1, K] int32 published-version ring


def router_of(nodes: torch.Tensor, num_routers: int) -> torch.Tensor:
    """Router site each request consults, ``[B]`` int32: node ``x`` maps to
    router ``x % R``."""
    return (nodes.long() % num_routers).to(torch.int32)


def init_router_state(
    hosts0: torch.Tensor,  # [K, N] initial replica map
    *,
    num_routers: int,
    cache_entries: int,
    publish_lag_chunks: int,
    active: bool,
    force_ring: bool = False,
) -> RouterState:
    """Cold-start router state on ``hosts0``'s device. ``force_ring`` makes
    the publish ring even at lag 0 (one slot, written at chunk end and read
    the next chunk, which gives the ringless values): failure injection
    needs a published view it can freeze while the directory home is down."""
    k, _ = hosts0.shape
    dev = hosts0.device
    bounded = cache_entries > 0
    ring = active and (publish_lag_chunks > 0 or force_ring)
    slots = publish_lag_chunks + 1
    return RouterState(
        cached=torch.zeros((num_routers, k), dtype=torch.bool, device=dev) if bounded else None,
        cached_ver=torch.zeros((num_routers, k), dtype=torch.int32, device=dev),
        score=torch.zeros((num_routers, k), dtype=torch.float32, device=dev) if bounded else None,
        ver=torch.zeros(k, dtype=torch.int32, device=dev) if active else None,
        ring_hosts=hosts0.unsqueeze(0).repeat(slots, 1, 1) if ring else None,
        ring_ver=torch.zeros((slots, k), dtype=torch.int32, device=dev) if ring else None,
    )


def published_view(
    rstate: RouterState,
    hosts: torch.Tensor,  # [K, N] the chunk's frozen authoritative map
    chunk: int,
    *,
    publish_lag_chunks: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The directory's published view at this chunk, ``(pub_hosts [K, N],
    pub_ver [K])``: the authoritative state ``publish_lag_chunks`` chunks
    ago (the initial map for the first chunks), a view of the ring's slot.
    Inactive policies never publish: their view is the frozen map at
    version zero."""
    if rstate.ver is None:
        return hosts, torch.zeros(hosts.shape[0], dtype=torch.int32, device=hosts.device)
    if rstate.ring_hosts is None:
        return hosts, rstate.ver
    slot = chunk % rstate.ring_hosts.shape[0]
    return rstate.ring_hosts[slot], rstate.ring_ver[slot]


def consult_probe(
    rstate: RouterState,
    rb: torch.Tensor,  # [B] int router site per request
    ck: torch.Tensor,  # [B] int key per request
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-request cache probe ``(cached [B] bool, fresh [B] bool, age [B]
    int32)``: ``fresh`` when the entry's refresh version has reached the
    key's version, ``age`` the version gap of a stale entry (0 elsewhere)."""
    rb, ck = rb.long(), ck.long()
    ent_ver = rstate.cached_ver[rb, ck]
    if rstate.cached is None:
        ent_cached = torch.ones(rb.shape, dtype=torch.bool, device=rb.device)
    else:
        ent_cached = rstate.cached[rb, ck]
    if rstate.ver is None:
        key_ver = torch.zeros(rb.shape, dtype=torch.int32, device=rb.device)
    else:
        key_ver = rstate.ver[ck]
    fresh = ent_cached & (ent_ver >= key_ver)
    age = torch.clamp_min(key_ver - ent_ver, 0)
    return ent_cached, fresh, age


def router_cache_update(
    rstate: RouterState,
    rb: torch.Tensor,  # [B] int router site per request
    ck: torch.Tensor,  # [B] int key per request
    consult: torch.Tensor,  # [B] bool requests that consulted the directory
    pub_ver: torch.Tensor,  # [K] int32 published version (what a refresh installs)
    *,
    cache_entries: int,
    decay: float,
    group=None,
) -> RouterState:
    """End-of-chunk cache maintenance: consulted entries refresh to the
    published version, the decay-LFU score folds the chunk's consults in,
    and (bounded) each router keeps its top ``cache_entries`` scores.

    A key-sharded rank (``group``, its own keys) ranks the union of every
    rank's local top ``cache_entries`` (gathered over the group): the
    global top ``cache_entries`` is a subset of it, so the threshold is
    exact.

    The consult counts are an f32 scatter-add of ones (exact in any order
    below 2**24). The reference's jitted engine contracts ``score * decay +
    counts`` into one fused multiply-add; the f64 product and sum here,
    rounded once, give its bits. The threshold is each router's
    ``cache_entries``-th largest score, a value that does not depend on the
    order of ties."""
    r, k = rstate.cached_ver.shape
    counts = torch.zeros(r * k, dtype=torch.float32, device=ck.device)
    counts.index_put_((rb.long() * k + ck.long(),), consult.to(torch.float32), accumulate=True)
    counts = counts.view(r, k)
    new_ver = torch.where(counts > 0.0, pub_ver[None, :], rstate.cached_ver)
    if cache_entries == 0:
        return rstate._replace(cached_ver=new_ver)
    decay_t = torch.full((), decay, dtype=torch.float32, device=ck.device).double()
    new_score = (rstate.score.double() * decay_t + counts.double()).to(torch.float32)
    cands = new_score
    if group is not None:
        local = torch.topk(new_score, min(cache_entries, k), dim=1, sorted=False).values
        cands = gather_ranks(local, group, dim=1)
    kth = torch.topk(cands, cache_entries, dim=1, sorted=False).values.amin(dim=1)
    new_cached = (new_score >= kth[:, None]) & (new_score > 0.0)
    return rstate._replace(cached=new_cached, cached_ver=new_ver, score=new_score)


def publish_commit(
    rstate: RouterState,
    changed: torch.Tensor,  # [K] bool keys whose replica row the daemon changed
    new_hosts: torch.Tensor,  # [K, N] the map the next chunk sees frozen
    chunk: int,
    *,
    publish_lag_chunks: int,
    daemon_up: bool | None = None,
) -> RouterState:
    """Fold one daemon step's versioned publish in: bump the version of
    every changed key and overwrite, in place, the ring slot this chunk
    read (next read ``publish_lag_chunks + 1`` chunks from now).

    ``daemon_up=False`` (the directory home node is down; the schedule is
    known on the host) pauses the publish pipeline: versions still bump,
    but the slot keeps the view it already served. ``None`` is the
    fault-free program."""
    if rstate.ver is None:
        return rstate
    ver = rstate.ver + changed.to(torch.int32)
    if rstate.ring_hosts is not None and (daemon_up is None or bool(daemon_up)):
        slot = chunk % rstate.ring_hosts.shape[0]
        rstate.ring_hosts[slot].copy_(new_hosts)
        rstate.ring_ver[slot].copy_(ver)
    return rstate._replace(ver=ver)


def stale_age_fold(age: torch.Tensor, stale: torch.Tensor) -> torch.Tensor:
    """One chunk's staleness-age histogram ``[STALE_AGE_BINS]`` f32: the
    version gap of every stale consult, the last bin absorbing ages
    ``>= STALE_AGE_BINS - 1``."""
    idx = torch.clamp(age.long(), 0, STALE_AGE_BINS - 1)
    hist = torch.zeros(STALE_AGE_BINS, dtype=torch.float32, device=age.device)
    return hist.index_put_((idx,), stale.to(torch.float32), accumulate=True)
