"""Plain PyTorch version of the fused chunk-replay pass (counterpart of
``src/repro/kernels/chunk_replay/ref.py``) — the yardstick the CUDA kernel in
``csrc/chunk_replay.cu`` is held to, and what the wrapper runs for tensors
that lie on the CPU.

One simulation chunk is a ``[B]`` slab of requests replayed against a
``[K, N]`` replica map frozen at chunk start:

  1. replica-row gather           ``replicas = hosts[keys]``        [B, N]
  2. nearest-replica read latency (Algorithm 1 over the RTT row, plus the
     size-aware transfer charge when the serving replica is remote)
  3. relay+broadcast write latency (Algorithm 2: relay to the master
     propagator, parallel post completing at the farthest owner)
  4. read-hit flags               ``replicas[b, nodes[b]]``
  5. per-node busy accumulation   ``busy[nodes[b]] += lat[b]``
  6. optional grouped ``[2N, B]`` latency-histogram fold
     (group id = node * 2 + is_read)

The f32 expressions keep the reference's op order (it sets the bits):
reads are ``(service + nearest) + (has_local ? 0 : xfer_r)``; writes are
``cost = relay + post; cost = cost + (cost > 0 ? xfer_w : 0)`` and then
``service + (sole_local ? 0 : cost)``; ``extra_ms`` is added after, and the
``valid`` mask last. Scalars enter as 0-dim f32 tensors so every add is an
f32 add, as in the reference's traced scalars.

``read_mode``: ``"map"`` reads consult the replica map, ``"no_local"``
hides the requesting node's own copy, ``"ideal"`` serves everything
locally at pure service cost.

The contention pre-pass (``contention_extra_ms_ref``, the M/M/1 model of
``kvsim.cluster.ServiceConfig``) prices each request's queueing wait from
the chunk's per-node demand fold and hands it to the replay as
``extra_ms``. Its f32 expressions follow the reference as its engine
compiles them, which is not quite as its source reads: XLA turns a division
by a compile-time constant into a multiply by the constant's f32 reciprocal
and contracts ``service + bytes * (1 / serve)`` into one fused
multiply-add. The port writes both out (the fused multiply-add as an f64
product and sum, rounded once). The demand fold is taken in f64 and rounded
once: deterministic on the card (no float atomics) and the same bits on
the CPU and the card wherever the f64 sum is exact; the reference's
sequential f32 scatter differs from it by a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.latency_histogram.ref import bin_index
from repro_torch.spmd import all_sum

__all__ = [
    "READ_MODES",
    "COMPONENTS",
    "NUM_COMPONENTS",
    "chunk_components_ref",
    "nearest_replica_rtt_ref",
    "read_latency_ref",
    "write_latency_ref",
    "chunk_latency_ref",
    "chunk_replay_ref",
    "serving_node_ref",
    "service_demand_ref",
    "load_factor_ref",
    "contention_wait_ref",
    "contention_extra_ms_ref",
    "contention_extra_ms_chunks_ref",
    "routing_extra_split_ref",
    "routing_extra_ms_ref",
    "fault_extra_ms_ref",
]

READ_MODES = ("map", "no_local", "ideal")

# The additive latency taxonomy of cost attribution, in row order:
#   service         the fixed per-request service cost
#   read_rtt        RTT to the nearest visible replica (reads)
#   write_relay     relay hop to the master propagator (writes)
#   write_broadcast the master's post to the farthest other owner (writes)
#   transfer        payload transfer charge (a remote read, a write whose
#                   relay and post cross a link)
#   contention_wait M/M/1 residence-time excess (contention_extra_ms_ref)
#   routing_detour  stale-directory forward hop and redirect
#   directory_fetch router cache-miss round trip to the home node
# The rows of a request sum to its latency; a row is zero where the request
# did not pay that component.
COMPONENTS = (
    "service",
    "read_rtt",
    "write_relay",
    "write_broadcast",
    "transfer",
    "contention_wait",
    "routing_detour",
    "directory_fetch",
)
NUM_COMPONENTS = len(COMPONENTS)
SLAB_ROWS = 1 << 22  # rows per slab of the whole-trace contention pre-pass


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


def _recip32(x) -> float:
    """The f32 reciprocal XLA folds a constant divisor into."""
    return float(np.float32(1.0) / np.float32(x))


def nearest_replica_rtt_ref(
    rtt: torch.Tensor, replicas: torch.Tensor, nodes: torch.Tensor
) -> torch.Tensor:
    """RTT from each requesting node to its nearest replica ``[B]``; an
    empty replica mask charges the worst RTT in the topology (the modelled
    backing-store fetch)."""
    row = rtt[nodes.long()]  # [B, N]
    masked = torch.where(replicas, row, _f32(float("inf"), rtt))
    nearest = masked.amin(dim=-1)
    return torch.where(torch.isfinite(nearest), nearest, rtt.max())


def read_latency_ref(rtt, replicas, nodes, *, service_ms, xfer_ms):
    """Geo read path: service + RTT to the nearest replica, + the payload
    transfer charge when the requesting node holds no visible copy."""
    nearest = nearest_replica_rtt_ref(rtt, replicas, nodes)
    has_local = replicas[torch.arange(replicas.shape[0], device=rtt.device), nodes.long()]
    zero = _f32(0.0, rtt)
    return (_f32(service_ms, rtt) + nearest) + torch.where(
        has_local, zero, _f32(xfer_ms, rtt)
    )


def write_latency_ref(
    rtt, replicas, nodes, sole_local_owner, *, service_ms, master: int, xfer_ms
):
    """Geo write path (Algorithm 2): relay to the master propagator, then a
    parallel post completing when the farthest owner acks; ``cost > 0``
    means a payload genuinely crossed a link and pays the transfer charge."""
    n = rtt.shape[0]
    zero = _f32(0.0, rtt)
    nodes = nodes.long()
    relay = torch.where(nodes == master, zero, rtt[nodes, master])
    others = torch.arange(n, device=rtt.device)[None, :] != master
    post = torch.where(replicas & others, rtt[master][None, :], zero).amax(dim=-1)
    cost = relay + post
    cost = cost + torch.where(cost > 0, _f32(xfer_ms, rtt), zero)
    return _f32(service_ms, rtt) + torch.where(sole_local_owner, zero, cost)


def chunk_latency_ref(
    hosts: torch.Tensor,  # [K, N] bool frozen replica map
    keys: torch.Tensor,  # [B] int
    nodes: torch.Tensor,  # [B] int
    is_read: torch.Tensor,  # [B] bool
    rtt: torch.Tensor,  # [N, N] f32
    *,
    service_ms,
    master: int,
    xfer_read_ms,
    xfer_write_ms,
    read_mode: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-request latency + read-hit flags: ``(lat [B] f32, hits [B] bool)``."""
    b = keys.shape[0]
    if read_mode == "ideal":
        return _f32(service_ms, rtt).expand(b).clone(), is_read.clone()

    replicas = hosts[keys.long()]  # [B, N]
    nodes_l = nodes.long()
    hit = replicas[torch.arange(b, device=rtt.device), nodes_l]
    if read_mode == "no_local":
        own = torch.arange(hosts.shape[1], device=rtt.device)[None, :] == nodes_l[:, None]
        read_replicas = replicas & ~own
        hit = torch.zeros_like(hit)
    else:
        read_replicas = replicas
    r_lat = read_latency_ref(
        rtt, read_replicas, nodes, service_ms=service_ms, xfer_ms=xfer_read_ms
    )
    sole_local = hit & (replicas.sum(dim=-1) == 1)
    w_lat = write_latency_ref(
        rtt, replicas, nodes, sole_local,
        service_ms=service_ms, master=master, xfer_ms=xfer_write_ms,
    )
    return torch.where(is_read, r_lat, w_lat), hit & is_read


def chunk_components_ref(
    hosts: torch.Tensor,  # [K, N] bool frozen replica map
    keys: torch.Tensor,  # [B] int
    nodes: torch.Tensor,  # [B] int
    is_read: torch.Tensor,  # [B] bool
    rtt: torch.Tensor,  # [N, N] f32
    *,
    service_ms,
    master: int,
    xfer_read_ms,
    xfer_write_ms,
    read_mode: str,
    contention_ms: torch.Tensor | None = None,  # [B] f32 (contention_extra_ms_ref)
    routing_detour_ms: torch.Tensor | None = None,  # [B] f32 (routing_extra_split_ref)
    directory_fetch_ms: torch.Tensor | None = None,  # [B] f32 (routing_extra_split_ref)
    avail: torch.Tensor | None = None,  # [N] bool (fault failover)
) -> torch.Tensor:
    """Per-request latency cut along :data:`COMPONENTS`: ``[NUM_COMPONENTS,
    B]`` f32.

    The same sub-expressions as :func:`chunk_latency_ref` (the same f32 bits
    each), routed into their rows: the read path's nearest RTT and transfer
    charge; the write path's relay, post and transfer charge, each zero for
    a sole local owner. So a request's rows sum to its latency plus its
    surcharges, up to f32 re-association (the write path rounds ``(relay +
    post) + xfer`` in one order). The pre-pass surcharges drop into their
    rows as given; an absent one is a zero row.

    With faults on the caller passes the availability-masked map and the
    chunk's ``avail``: the write legs then go through the master that
    ``fault_extra_ms_ref`` elects (``master`` if it is up, else the first
    live node), so the rows take in the failover delta the engines add
    through ``extra_ms``."""
    b = keys.shape[0]
    dev = rtt.device
    zeros = torch.zeros(b, dtype=torch.float32, device=dev)
    service = _f32(service_ms, rtt).expand(b)
    if read_mode == "ideal":
        read_rtt = write_relay = write_broadcast = transfer = zeros
    else:
        n = rtt.shape[0]
        zero = _f32(0.0, rtt)
        keys_l, nodes_l = keys.long(), nodes.long()
        rows = torch.arange(b, device=dev)
        col = torch.arange(n, device=dev)[None, :]
        replicas = hosts[keys_l]  # [B, N]
        hit = replicas[rows, nodes_l]
        read_replicas = replicas & (col != nodes_l[:, None]) if read_mode == "no_local" else replicas
        nearest = nearest_replica_rtt_ref(rtt, read_replicas, nodes)
        has_local = read_replicas[rows, nodes_l]
        r_xfer = torch.where(has_local, zero, _f32(xfer_read_ms, rtt))
        sole_local = hit & (replicas.sum(dim=-1) == 1)
        if read_mode == "no_local":
            sole_local = torch.zeros_like(sole_local)
        if avail is None:
            w_master = torch.full((), master, dtype=torch.int64, device=dev)
        else:
            w_master = torch.where(avail[master], torch.full((), master, dtype=torch.int64, device=dev),
                                   avail.to(torch.int32).argmax())
        relay = torch.where(nodes_l == w_master, zero, rtt[nodes_l, w_master])
        post = torch.where(replicas & (col != w_master), rtt[w_master][None, :], zero).amax(dim=-1)
        w_xfer = torch.where(relay + post > 0, _f32(xfer_write_ms, rtt), zero)
        paid = ~sole_local
        read_rtt = torch.where(is_read, nearest, zero)
        write_relay = torch.where(is_read, zero, torch.where(paid, relay, zero))
        write_broadcast = torch.where(is_read, zero, torch.where(paid, post, zero))
        transfer = torch.where(is_read, r_xfer, torch.where(paid, w_xfer, zero))
    rows8 = [service, read_rtt, write_relay, write_broadcast, transfer,
             zeros if contention_ms is None else contention_ms,
             zeros if routing_detour_ms is None else routing_detour_ms,
             zeros if directory_fetch_ms is None else directory_fetch_ms]
    return torch.stack([x.to(torch.float32) for x in rows8])


def chunk_replay_ref(
    hosts: torch.Tensor,  # [K, N] bool
    keys: torch.Tensor,  # [B] int
    nodes: torch.Tensor,  # [B] int
    is_read: torch.Tensor,  # [B] bool
    valid: torch.Tensor,  # [B] bool (False masks rows)
    rtt: torch.Tensor,  # [N, N] f32
    *,
    service_ms,
    master: int,
    xfer_read_ms,
    xfer_write_ms,
    read_mode: str,
    num_bins: int = 0,
    lo: float = 1.0,
    hi: float = 10_000.0,
    extra_ms: torch.Tensor | None = None,  # [B] f32 per-request surcharge
    lat_out: torch.Tensor | None = None,  # [B] f32, written when given
    hit_out: torch.Tensor | None = None,  # [B] bool, written when given
):
    """The whole fused pass. Returns ``(busy [N] f32, lat_sum f32,
    hits i64, reads i64, count i64, hist)`` where ``hist`` is the
    ``[2N, num_bins]`` int32 grouped latency histogram, ``None`` when
    ``num_bins == 0``. When the caller passes them, ``lat_out`` receives
    each request's latency (after ``extra_ms`` and the valid mask, the
    value the histogram bins) and ``hit_out`` its read-hit flag (a valid
    read whose node holds a copy)."""
    n = rtt.shape[0]
    lat, read_hits = chunk_latency_ref(
        hosts, keys, nodes, is_read, rtt,
        service_ms=service_ms, master=master,
        xfer_read_ms=xfer_read_ms, xfer_write_ms=xfer_write_ms,
        read_mode=read_mode,
    )
    if extra_ms is not None:
        lat = lat + extra_ms
    lat = torch.where(valid, lat, _f32(0.0, rtt))
    if lat_out is not None:
        lat_out.copy_(lat)
    if hit_out is not None:
        hit_out.copy_(read_hits & valid)
    # Sums run in f64 and round once to f32. Where an f32 sum is exact
    # (whole-ms latencies, totals below 2**24) this gives its bits; over a
    # whole 10**8-request trace it stays the correctly rounded total, where
    # a running f32 sum (or f32 atomics) would drop whole milliseconds.
    busy = torch.zeros(n, dtype=torch.float64, device=rtt.device)
    busy = busy.index_add_(0, nodes.long(), lat.double()).float()
    lat_sum = lat.sum(dtype=torch.float64).float()
    hits = (read_hits & valid).sum()
    reads = (is_read & valid).sum()
    count = valid.sum()
    if num_bins == 0:
        return busy, lat_sum, hits, reads, count, None
    group = nodes.long() * 2 + is_read.long()
    idx = bin_index(lat, lo, hi, num_bins).long()
    hist = torch.zeros(2 * n * num_bins, dtype=torch.int32, device=rtt.device)
    hist.index_put_(
        (group * num_bins + idx,), valid.to(torch.int32), accumulate=True
    )
    return busy, lat_sum, hits, reads, count, hist.reshape(2 * n, num_bins)


# ---------------------------------------------------------------------------
# Queueing-aware contention (kvsim.cluster.ServiceConfig). The pre-pass needs
# the whole chunk's per-node demand fold before any request's wait is known,
# so it runs ahead of the replay and hands it a per-request ``extra_ms``.
# Every function takes one chunk ``[B]`` or a batch of chunks ``[C, B]``.
# ---------------------------------------------------------------------------


def serving_node_ref(
    replicas: torch.Tensor,  # [..., B, N] bool
    nodes: torch.Tensor,  # [..., B] int
    is_read: torch.Tensor,  # [..., B] bool
    rtt: torch.Tensor,  # [N, N] f32
    *,
    read_mode: str,
) -> torch.Tensor:
    """Per-request serving node (int64): reads are served by the nearest
    visible replica (the first on an RTT tie; the requesting node itself
    when none is visible, as it fetches from the backing store), writes by
    the requesting node."""
    nodes_l = nodes.long()
    if read_mode == "ideal":
        return nodes_l
    visible = replicas
    if read_mode == "no_local":
        own = torch.arange(rtt.shape[0], device=rtt.device) == nodes_l[..., None]
        visible = replicas & ~own
    masked = torch.where(visible, rtt[nodes_l], _f32(float("inf"), rtt))
    nearest = masked.argmin(dim=-1)
    read_serving = torch.where(visible.any(dim=-1), nearest, nodes_l)
    return torch.where(is_read, read_serving, nodes_l)


def service_demand_ref(obj_bytes: torch.Tensor, *, service_ms, serve_bytes_per_ms) -> torch.Tensor:
    """Per-request service demand in ms, ``service + bytes / serve``, as
    the reference's compiled program forms it: one rounding of
    ``bytes * f32(1 / serve) + service`` (see the module docstring)."""
    prod = obj_bytes.double() * _recip32(serve_bytes_per_ms)  # exact in f64
    return (prod + float(np.float32(service_ms))).float()


def load_factor_ref(
    serving: torch.Tensor,  # [..., B] int
    demand: torch.Tensor,  # [..., B] f32
    valid: torch.Tensor,  # [..., B] bool
    *,
    num_nodes: int,
    capacity_ms,
    rho_max,
    group=None,
) -> torch.Tensor:
    """Per-node load factor ``rho [..., N]`` f32: the chunk's valid demand
    folded per serving node (in f64, rounded once), over the capacity,
    clamped below the stability bound. With a ``group`` (a key-sharded
    rank, ``valid`` holding its own requests) the f64 folds of every rank
    are summed before the rounding: the load factor is the cluster's, and
    the same bits as one rank's fold of every request."""
    one_hot = serving.long()[..., None] == torch.arange(num_nodes, device=serving.device)
    zero = torch.zeros((), dtype=torch.float64, device=demand.device)
    contrib = torch.where(one_hot & valid[..., None], demand.double()[..., None], zero)
    fold = all_sum(contrib.sum(dim=-2), group).float()
    return torch.minimum(fold * _f32(_recip32(capacity_ms), demand), _f32(rho_max, demand))


def contention_wait_ref(demand: torch.Tensor, rho: torch.Tensor, serving: torch.Tensor) -> torch.Tensor:
    """M/M/1 residence-time excess per request, ``d * rho / (1 - rho)`` at
    its serving node (``rho [..., N]``, ``serving [..., B]``)."""
    r = torch.gather(rho, -1, serving.long())
    return demand * r / (_f32(1.0, demand) - r)


def contention_extra_ms_ref(
    hosts: torch.Tensor,  # [K, N] bool
    keys: torch.Tensor,  # [..., B] int
    nodes: torch.Tensor,  # [..., B] int
    is_read: torch.Tensor,  # [..., B] bool
    valid: torch.Tensor,  # [..., B] bool
    rtt: torch.Tensor,  # [N, N] f32
    obj_bytes: torch.Tensor,  # [K] f32 per-key object sizes
    *,
    read_mode: str,
    service_ms,
    serve_bytes_per_ms,
    capacity_ms,
    rho_max,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The contention pre-pass: ``(extra_ms [..., B] f32, rho [..., N] f32)``.
    A key-sharded rank passes its own ``hosts``, ``obj_bytes`` and local
    keys, ``valid`` masked to its own requests, and its ``group``."""
    keys_l = keys.long()
    replicas = None if read_mode == "ideal" else hosts[keys_l]
    serving = serving_node_ref(replicas, nodes, is_read, rtt, read_mode=read_mode)
    demand = service_demand_ref(
        obj_bytes[keys_l], service_ms=service_ms, serve_bytes_per_ms=serve_bytes_per_ms
    )
    rho = load_factor_ref(
        serving, demand, valid, num_nodes=rtt.shape[0], capacity_ms=capacity_ms, rho_max=rho_max,
        group=group,
    )
    return contention_wait_ref(demand, rho, serving), rho


def contention_extra_ms_chunks_ref(
    hosts: torch.Tensor,  # [K, N] bool, frozen for the whole trace
    keys: torch.Tensor,  # [R] int
    nodes: torch.Tensor,  # [R] int
    is_read: torch.Tensor,  # [R] bool
    rtt: torch.Tensor,  # [N, N] f32
    obj_bytes: torch.Tensor,  # [K] f32
    *,
    chunk_size: int,
    **kw,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The pre-pass over a whole trace cut into chunks of ``chunk_size``
    requests against one frozen map (the static path): ``(extra_ms [R],
    rho [C, N])``, chunk ``c`` being what ``contention_extra_ms_ref`` gives
    for requests ``[c*B, (c+1)*B)``. The last chunk is padded with masked
    rows. Slabs of whole chunks (about ``SLAB_ROWS`` rows) bound the
    ``[rows, N]`` temporaries."""
    r = keys.shape[0]
    c = -(-r // chunk_size)
    pad = c * chunk_size - r

    def padded(x):
        return torch.cat([x, x.new_zeros(pad)]) if pad else x

    pk, pn, pr = padded(keys), padded(nodes), padded(is_read)
    pv = torch.arange(c * chunk_size, device=keys.device) < r
    per_slab = max(1, SLAB_ROWS // chunk_size)
    extra, rho = [], []
    for lo in range(0, c, per_slab):
        rows = slice(lo * chunk_size, min(lo + per_slab, c) * chunk_size)
        e, p = contention_extra_ms_ref(
            hosts, *(x[rows].view(-1, chunk_size) for x in (pk, pn, pr, pv)),
            rtt, obj_bytes, **kw,
        )
        extra.append(e.reshape(-1))
        rho.append(p)
    return torch.cat(extra)[:r], torch.cat(rho)


# ---------------------------------------------------------------------------
# Routing-tier pricing (kvsim.routing.RoutingConfig) and failure-injection
# pricing (kvsim.faults.FaultConfig): torch pre-passes like the contention
# one, each giving a per-request surcharge that the engines compose into
# ``extra_ms``. The reference computes them outside its Pallas kernel too.
# ---------------------------------------------------------------------------


def routing_extra_split_ref(
    hosts: torch.Tensor,  # [K, N] bool authoritative frozen map (true serving)
    pub_hosts: torch.Tensor,  # [K, N] bool published (lagged) directory view
    cached: torch.Tensor,  # [B] bool the consulted router caches this key
    fresh: torch.Tensor,  # [B] bool ... at the key's current publish version
    keys: torch.Tensor,  # [B] int
    nodes: torch.Tensor,  # [B] int
    is_read: torch.Tensor,  # [B] bool
    valid: torch.Tensor,  # [B] bool
    rtt: torch.Tensor,  # [N, N] f32
    *,
    read_mode: str,
    home_node: int,
) -> tuple[torch.Tensor, ...]:
    """The routing pre-pass, ``(detour_ms [B] f32, fetch_ms [B] f32,
    consults, fetches, stale, mis_routed)`` (the last four ``[B]`` bool).

    A request consults its router when it needs ownership knowledge: a read
    with no local replica under ``"map"``, every read under ``"no_local"``,
    none under ``"ideal"``, never a write. A fresh entry routes at no extra
    cost; a stale one routes by the published map and, where the published
    serving node differs from the true one, pays ``(rtt[x, s_pub] +
    rtt[s_pub, s_true]) - rtt[x, s_true]``; a miss first pays the fetch
    ``rtt[x, home_node]`` and then the same detour."""
    b = keys.shape[0]
    if read_mode == "ideal":
        zeros_f = torch.zeros(b, dtype=torch.float32, device=rtt.device)
        zeros_b = torch.zeros(b, dtype=torch.bool, device=rtt.device)
        return zeros_f, zeros_f.clone(), zeros_b, zeros_b.clone(), zeros_b.clone(), zeros_b.clone()
    keys_l, nodes_l = keys.long(), nodes.long()
    replicas = hosts[keys_l]  # [B, N]
    local = replicas[torch.arange(b, device=rtt.device), nodes_l]
    consult = is_read & valid if read_mode == "no_local" else is_read & ~local & valid
    s_true = serving_node_ref(replicas, nodes, is_read, rtt, read_mode=read_mode)
    s_pub = serving_node_ref(pub_hosts[keys_l], nodes, is_read, rtt, read_mode=read_mode)
    mis = s_pub != s_true
    zero = _f32(0.0, rtt)
    detour = torch.where(mis, rtt[nodes_l, s_pub] + rtt[s_pub, s_true] - rtt[nodes_l, s_true], zero)
    stale_or_miss = consult & ~fresh
    detour_part = torch.where(stale_or_miss, detour, zero)
    fetch_part = torch.where(stale_or_miss & ~cached, rtt[nodes_l, home_node], zero)
    return (detour_part, fetch_part, consult, consult & ~cached, consult & cached & ~fresh,
            stale_or_miss & mis)


def routing_extra_ms_ref(hosts, pub_hosts, cached, fresh, keys, nodes, is_read, valid, rtt, *,
                         read_mode: str, home_node: int) -> tuple[torch.Tensor, ...]:
    """:func:`routing_extra_split_ref` with the two surcharges added:
    ``(extra_ms [B] f32, consults, fetches, stale, mis_routed)``."""
    detour, fetch, *flags = routing_extra_split_ref(
        hosts, pub_hosts, cached, fresh, keys, nodes, is_read, valid, rtt,
        read_mode=read_mode, home_node=home_node,
    )
    return (detour + fetch, *flags)


def fault_extra_ms_ref(
    hosts: torch.Tensor,  # [K, N] bool authoritative map (crash losses applied)
    keys: torch.Tensor,  # [B] int
    nodes: torch.Tensor,  # [B] int
    is_read: torch.Tensor,  # [B] bool
    valid: torch.Tensor,  # [B] bool
    avail: torch.Tensor,  # [N] bool this chunk's node availability
    rtt: torch.Tensor,  # [N, N] f32
    *,
    read_mode: str,
    master: int,
    xfer_write_ms,
    wiped: torch.Tensor | None = None,  # [K] bool keys that lost every replica
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The failure pre-pass, ``(extra_ms [B] f32, unavailable [B] bool,
    failover [B] bool)``.

    A request is unavailable when its origin node is down, or when it is a
    read whose key has copies somewhere but none visible on a live node, or
    whose key was wiped by a crash and not re-seeded yet. Served writes
    relay through the first live node when the master is down; ``extra_ms``
    is that write's cost through the stand-in minus its cost through the
    master on the live replica set (``w_deg - w_base``, negative where the
    stand-in is nearer), so with every node up it is exactly ``+0.0``. Reads
    need no surcharge: the engine prices them on ``hosts & avail``."""
    b = keys.shape[0]
    dev = rtt.device
    keys_l, nodes_l = keys.long(), nodes.long()
    origin_down = ~avail[nodes_l]
    if read_mode == "ideal":
        return (torch.zeros(b, dtype=torch.float32, device=dev), origin_down & valid,
                torch.zeros(b, dtype=torch.bool, device=dev))
    n = rtt.shape[0]
    col = torch.arange(n, device=dev)[None, :]
    replicas = hosts[keys_l]  # [B, N]
    vis_base = replicas & (col != nodes_l[:, None]) if read_mode == "no_local" else replicas
    vis_live = vis_base & avail[None, :]
    read_dark = vis_base.any(dim=-1) & ~vis_live.any(dim=-1)
    if wiped is not None:
        read_dark = read_dark | wiped[keys_l]
    unavailable = (origin_down | (is_read & read_dark)) & valid

    live = replicas & avail[None, :]
    hit_live = live[torch.arange(b, device=dev), nodes_l]
    sole_local = hit_live & (live.sum(dim=-1) == 1)
    if read_mode == "no_local":
        sole_local = torch.zeros_like(sole_local)
    zero, xfer = _f32(0.0, rtt), _f32(xfer_write_ms, rtt)

    def write_cost(m):  # Algorithm 2's relay + broadcast through master m, as chunk_latency_ref
        relay = torch.where(nodes_l == m, zero, rtt[nodes_l, m])
        post = torch.where(live & (col != m), rtt[m][None, :], zero).amax(dim=-1)
        cost = relay + post
        cost = cost + torch.where(cost > 0, xfer, zero)
        return torch.where(sole_local, zero, cost)

    w_base = write_cost(torch.full((), master, dtype=torch.int64, device=dev))
    # The stand-in master: the first live node (argmax takes the first maximum).
    m_star = torch.where(avail[master], torch.full((), master, dtype=torch.int64, device=dev),
                         avail.to(torch.int32).argmax())
    w_deg = write_cost(m_star)
    served_write = ~is_read & ~unavailable & valid
    extra = torch.where(served_write, w_deg - w_base, zero)
    failover = served_write & ~avail[master] & ~sole_local
    return extra, unavailable, failover
