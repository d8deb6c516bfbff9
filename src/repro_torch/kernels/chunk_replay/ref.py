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
"""

from __future__ import annotations

import torch

from repro_torch.kernels.latency_histogram.ref import bin_index

__all__ = [
    "READ_MODES",
    "nearest_replica_rtt_ref",
    "read_latency_ref",
    "write_latency_ref",
    "chunk_latency_ref",
    "chunk_replay_ref",
]

READ_MODES = ("map", "no_local", "ideal")


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float(x), dtype=torch.float32, device=like.device)


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
):
    """The whole fused pass. Returns ``(busy [N] f32, lat_sum f32,
    hits i64, reads i64, count i64, hist)`` where ``hist`` is the
    ``[2N, num_bins]`` int32 grouped latency histogram, ``None`` when
    ``num_bins == 0``."""
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
