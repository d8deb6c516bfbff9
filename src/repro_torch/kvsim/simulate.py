"""Trace-driven simulation of the paper's experiment (§8–§9) on one device
(counterpart of ``src/repro/kvsim/simulate.py::run_scenario``).

The trace is processed in chunks of ``daemon_interval`` requests. Within a
chunk every request sees the replica map frozen at chunk start (the paper's
non-blocking property). Per chunk, in this order:

  1. ``chunk_replay`` prices the chunk's requests against the frozen map
     and folds busy time, latency sum and hit/read counts;
  2. per-node occupancy is sampled on that same map (the running peak
     starts at the initial map's occupancy);
  3. ``record_accesses`` folds the chunk's accesses into the metadata;
  4. on a due tick (``chunk % period == 0``) the Redynis sweep
     (``ownership_sweep``) rewrites the map.

Static policies never change the map, so their whole trace is replayed in
one ``chunk_replay`` launch: the same sums, re-associated, as the
reference's static fast path does. All accumulators stay on the device and
are read back once at the end; f32 aggregates accumulate in f32 in chunk
order, as the reference's scan carry does.

Contention (``ClusterConfig.service``, an enabled ``ServiceConfig``): before
step 1 each chunk runs the M/M/1 pre-pass on its frozen map
(``contention_extra_ms_ref``), and the replay adds each request's wait as
``extra_ms``. On the static path the pre-pass runs over all chunks at once.

Telemetry (``telemetry=TelemetryConfig()``): the run also returns a
``SimTrace``. On the active path ``chunk_replay`` folds each chunk's
``[2N, B]`` histogram in the same launch, and the per-chunk counters,
moves, occupancy and load factor stay on the device; on the static path
the whole-trace launch also writes each request's latency and read-hit
flag, one ``latency_histogram`` launch bins them into ``[C, 2N, B]``, and
reshape-sums give the other per-chunk series. Everything is read back once
at the end, and ``telemetry.build_trace`` runs on the host.

Throughput model: nodes serve their request streams concurrently;
per-node busy time = Σ latency of requests arriving there; makespan = max
over nodes; throughput = R / makespan.

This slice covers a materialised trace on one device with routing, faults,
finite capacity, sharding and telemetry attribution off; each of those
raises ``NotImplementedError`` naming its later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.metadata import create_store, record_accesses
from repro_torch.core.policy import (
    PolicyContext,
    policy_masked_step,
    split_policy,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.chunk_replay.ops import chunk_replay
from repro_torch.kernels.chunk_replay.ref import (
    contention_extra_ms_chunks_ref,
    contention_extra_ms_ref,
)
from repro_torch.kvsim import telemetry as telemetry_mod
from repro_torch.kvsim.cluster import ClusterConfig, normalize_service
from repro_torch.kvsim.telemetry import (
    STALE_AGE_BINS,
    SimTrace,
    TelemetryConfig,
    TelemetryLeaves,
    build_trace,
    normalize_telemetry,
)
from repro_torch.kvsim.workload import Trace, WorkloadConfig, generate_trace

__all__ = ["SimResult", "run_scenario"]


class SimResult(NamedTuple):
    """Aggregate metrics for one scenario run (one seed)."""

    throughput_ops_s: float
    hit_rate: float
    mean_latency_ms: float
    node_busy_ms: np.ndarray  # [N]
    replication_moves: float  # replicas created by the daemon
    deletion_moves: float  # replicas dropped by the daemon (all causes)
    evictions: float  # subset of deletions caused by key expiry
    capacity_evictions: float  # held replicas evicted by the budget projection
    peak_occupancy_bytes: np.ndarray  # [N] peak replica bytes per node
    router_consults: float = 0.0
    directory_fetches: float = 0.0
    mis_routes: float = 0.0
    stale_consults: float = 0.0
    unavailable_reads: float = 0.0
    unavailable_writes: float = 0.0
    failovers: float = 0.0
    repair_moves: float = 0.0


def _initial_hosts(
    natural_node: torch.Tensor, num_keys: int, num_nodes: int, placement: str
) -> torch.Tensor:
    """Starting replica map: ``"full"`` is every key everywhere; ``"offsite"``
    starts each key on the node after its natural request source."""
    dev = natural_node.device
    if placement == "full":
        return torch.ones((num_keys, num_nodes), dtype=torch.bool, device=dev)
    home = (natural_node.long() + 1) % num_nodes
    return home[:, None] == torch.arange(num_nodes, device=dev)[None, :]


def _seed_store(hosts: torch.Tensor, num_keys: int, num_nodes: int):
    """Metadata layer seeded with the initial placement. ``home`` stays
    zero: only the routing and failure-injection slices read it."""
    dev = hosts.device
    return create_store(num_keys, num_nodes, dev)._replace(
        hosts=hosts, live=torch.ones(num_keys, dtype=torch.bool, device=dev)
    )


def _replay_scalars(cluster: ClusterConfig) -> dict:
    """The latency-model scalars ``chunk_replay`` consumes."""
    return dict(
        service_ms=cluster.service_ms,
        master=cluster.master,
        xfer_read_ms=cluster.transfer_ms(cluster.value_bytes),
        xfer_write_ms=cluster.transfer_ms(cluster.value_bytes + cluster.key_bytes),
    )


def _node_occupancy(hosts: torch.Tensor, object_bytes: torch.Tensor) -> torch.Tensor:
    """Per-node replica bytes ``[N]`` under a replica map."""
    zero = torch.zeros((), dtype=torch.float32, device=hosts.device)
    return torch.where(hosts, object_bytes[:, None], zero).sum(dim=0)


def _contention_kwargs(cluster: ClusterConfig, read_mode: str, daemon_interval: int) -> dict | None:
    """What ``contention_extra_ms_ref`` needs, or ``None`` when the cluster
    has no enabled ``ServiceConfig``."""
    service = normalize_service(cluster.service)
    if service is None:
        return None
    return dict(
        read_mode=read_mode,
        service_ms=cluster.service_ms,
        serve_bytes_per_ms=service.serve_bytes_per_ms,
        capacity_ms=service.capacity_ms(daemon_interval, cluster.service_ms),
        rho_max=service.rho_max,
    )


def _check_slice(workload, cluster, trace_mode, num_shards) -> None:
    """Reject what this slice does not cover, naming the slice that will."""
    later = [
        (cluster.has_finite_capacity, "a finite capacity_bytes (the capacity slice)"),
        (cluster.routing is not None, "ClusterConfig.routing (the routing slice)"),
        (cluster.faults is not None, "ClusterConfig.faults (the failure-injection slice)"),
        (trace_mode == "streamed", "trace_mode='streamed' (the streamed-trace slice)"),
        (num_shards > 1, "num_shards > 1 (the key-sharded engine slice)"),
    ]
    for hit, what in later:
        if hit:
            raise NotImplementedError(f"run_scenario: {what} is not ported yet")
    if trace_mode != "materialized":
        raise ValueError(f"run_scenario: unknown trace_mode={trace_mode!r}")
    if workload.num_nodes != cluster.num_nodes:
        raise ValueError(
            f"workload has {workload.num_nodes} nodes but cluster topology "
            f"has {cluster.num_nodes}"
        )
    if cluster.rtt is not None and len(cluster.rtt) != cluster.num_nodes:
        raise ValueError(
            f"rtt matrix has {len(cluster.rtt)} rows but num_nodes={cluster.num_nodes}"
        )


def run_scenario(
    workload: WorkloadConfig,
    cluster: ClusterConfig,
    policy=None,
    seed: int = 0,
    daemon_interval: int = 1000,
    *,
    device: str | torch.device | None = None,
    trace: Trace | None = None,
    telemetry: TelemetryConfig | None = None,
    trace_mode: str = "materialized",
    num_shards: int = 1,
) -> SimResult | tuple[SimResult, SimTrace]:
    """Simulate one policy over one trace.

    ``trace`` replays a trace built elsewhere (``interop.trace_from_numpy``);
    otherwise ``generate_trace(workload, seed)`` draws one on the device.
    ``device=None`` runs on CUDA and raises without a card; the CPU runs only
    when asked for (``device="cpu"``), through the kernels' plain versions.
    With an enabled ``telemetry`` the call returns ``(SimResult, SimTrace)``.
    """
    _check_slice(workload, cluster, trace_mode, num_shards)
    tcfg = normalize_telemetry(telemetry)
    if policy is None:
        raise ValueError(
            "run_scenario: a policy is required — e.g. RedynisPolicy() or "
            "StaticPolicy(mode='local')"
        )
    if daemon_interval < 1:
        raise ValueError(f"run_scenario: daemon_interval={daemon_interval} must be >= 1")
    dev = resolve_device(device)
    policy = policy.resolve(workload.num_nodes)
    policy.validate(workload.num_nodes)
    static, params = split_policy(policy)

    if trace is None:
        trace = generate_trace(workload, seed, device=dev)
    trace = trace.to(dev)
    keys, nodes, is_read = trace.keys, trace.nodes, trace.is_read
    r = keys.shape[0]
    k, n = trace.natural_node.shape[0], cluster.num_nodes
    if r == 0:
        raise ValueError("run_scenario: the trace holds no request")
    rtt = cluster.rtt_matrix(dev)
    obj = trace.object_bytes.to(torch.float32)
    scalars = _replay_scalars(cluster)
    read_mode = static.read_mode

    store = _seed_store(
        _initial_hosts(trace.natural_node, k, n, static.initial_placement), k, n
    )
    peak = _node_occupancy(store.hosts, obj)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    moves = torch.zeros(4, **i64)  # adds, drops, expiry evictions, capacity
    contention = _contention_kwargs(cluster, read_mode, daemon_interval)
    bins = {} if tcfg is None else dict(num_bins=tcfg.num_bins, lo=tcfg.lo_ms, hi=tcfg.hi_ms)
    num_chunks = -(-r // daemon_interval)

    if not static.is_active:
        # A frozen map makes the whole request path loop-invariant: one
        # launch over the whole trace.
        extra = rho = None
        if contention is not None:
            extra, rho = contention_extra_ms_chunks_ref(
                store.hosts, keys, nodes, is_read, rtt, obj,
                chunk_size=daemon_interval, **contention,
            )
        lat = hit = None
        if tcfg is not None:
            lat = torch.empty(r, **f32)
            hit = torch.empty(r, dtype=torch.bool, device=dev)
        busy, lat_sum, hits, reads, _, _ = chunk_replay(
            store.hosts, keys, nodes, is_read,
            torch.ones(r, dtype=torch.bool, device=dev), rtt,
            read_mode=read_mode, extra_ms=extra, lat_out=lat, hit_out=hit, **scalars,
        )
        if tcfg is not None:
            series = _static_series(
                tcfg, lat, hit, nodes, is_read, daemon_interval, num_chunks, n, peak, rho
            )
    else:
        ctx = PolicyContext(rtt=rtt, object_bytes=obj, capacity_bytes=None, params=params)
        valid = torch.ones(min(daemon_interval, r), dtype=torch.bool, device=dev)
        busy = torch.zeros(n, **f32)
        lat_sum = torch.zeros((), **f32)
        hits = torch.zeros((), **i64)
        reads = torch.zeros((), **i64)
        pstate = ()
        per_chunk = []  # device tensors of each chunk, stacked at the end
        for c in range(num_chunks):
            lo, hi = c * daemon_interval, min((c + 1) * daemon_interval, r)
            ck, cn, cr = keys[lo:hi], nodes[lo:hi], is_read[lo:hi]
            cv = valid[: hi - lo]
            extra = rho = None
            if contention is not None:
                extra, rho = contention_extra_ms_ref(
                    store.hosts, ck, cn, cr, cv, rtt, obj, **contention
                )
            d_busy, d_lat, d_hits, d_reads, d_count, hist = chunk_replay(
                store.hosts, ck, cn, cr, cv, rtt, read_mode=read_mode,
                extra_ms=extra, **bins, **scalars,
            )
            busy = busy + d_busy
            lat_sum = lat_sum + d_lat
            hits += d_hits
            reads += d_reads
            occ = _node_occupancy(store.hosts, obj)
            peak = torch.maximum(peak, occ)
            store = record_accesses(store, ck, cn, now=c, valid=cv)
            stats, pstate, store = policy_masked_step(
                static, pstate, store, c, c % static.period == 0, ctx
            )
            stats = torch.stack(stats)
            moves += stats
            if tcfg is not None:
                per_chunk.append((hist, d_hits, d_reads, d_lat, d_count, stats, occ, rho))
        if tcfg is not None:
            series = _active_series(per_chunk, n)

    # f32 epilogue as in the reference, then ONE device-to-host copy.
    # Divisors are tensors: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which is not the reference's f32 division.
    r_f = torch.full((), float(r), **f32)
    tput = r_f / (busy.max() / torch.full((), 1000.0, **f32))
    hit_rate = hits.to(torch.float32) / torch.clamp_min(reads.to(torch.float32), 1.0)
    mean_lat = lat_sum / r_f
    parts = [torch.stack([tput, hit_rate, mean_lat]), busy, moves, peak]
    if tcfg is not None:
        parts += list(series.values())
    out = torch.cat([p.to(torch.float64).reshape(-1) for p in parts]).cpu().numpy()
    result = SimResult(
        throughput_ops_s=float(out[0]),
        hit_rate=float(out[1]),
        mean_latency_ms=float(out[2]),
        node_busy_ms=out[3 : 3 + n],
        replication_moves=float(out[3 + n]),
        deletion_moves=float(out[4 + n]),
        evictions=float(out[5 + n]),
        capacity_evictions=float(out[6 + n]),
        peak_occupancy_bytes=out[7 + n : 7 + 2 * n],
    )
    if tcfg is None:
        return result
    at = 7 + 2 * n
    host = {}
    for name, t in series.items():
        host[name] = out[at : at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
    return result, build_trace(_leaves(host, static.is_active, num_chunks), tcfg)


def _active_series(per_chunk: list, n: int) -> dict:
    """Stack the active path's per-chunk device tensors into the ``[C, ...]``
    series (still on the device)."""
    hist, hits, reads, lat_sum, count, stats, occ, rho = zip(*per_chunk)
    stats = torch.stack(stats)  # [C, 4]
    load = (
        torch.zeros((len(occ), n), dtype=torch.float32, device=occ[0].device)
        if rho[0] is None else torch.stack(rho)
    )
    return dict(
        hist=torch.stack(hist), hits=torch.stack(hits), reads=torch.stack(reads),
        lat_sum=torch.stack(lat_sum), count=torch.stack(count), adds=stats[:, 0],
        drops=stats[:, 1], expiry_evictions=stats[:, 2], capacity_evictions=stats[:, 3],
        occupancy=torch.stack(occ), load_factor=load,
    )


def _static_series(tcfg, lat, hit, nodes, is_read, chunk_size, num_chunks, n, occ0, rho) -> dict:
    """The static path's per-chunk series from its per-request latencies
    and read-hit flags (still on the device)."""
    dev = lat.device
    r = lat.shape[0]
    pad = num_chunks * chunk_size - r

    def chunk_sums(x, **kw):
        x = torch.cat([x, x.new_zeros(pad)]) if pad else x
        return x.view(num_chunks, chunk_size).sum(dim=1, **kw)

    group = (nodes * 2 + is_read.to(torch.int32)).to(torch.int32)
    weight = torch.ones(r, dtype=torch.float32, device=dev)
    hist = telemetry_mod.trace_histogram(lat, group, weight, tcfg, n, rows_per_chunk=chunk_size)
    count = torch.full((num_chunks,), float(chunk_size), dtype=torch.float32, device=dev)
    count[-1] = float(r - (num_chunks - 1) * chunk_size)
    zeros_c = torch.zeros(num_chunks, dtype=torch.float32, device=dev)
    return dict(
        hist=hist, hits=chunk_sums(hit), reads=chunk_sums(is_read),
        lat_sum=chunk_sums(lat, dtype=torch.float64).float(), count=count,
        adds=zeros_c, drops=zeros_c, expiry_evictions=zeros_c, capacity_evictions=zeros_c,
        occupancy=occ0.expand(num_chunks, n),
        load_factor=torch.zeros((num_chunks, n), dtype=torch.float32, device=dev)
        if rho is None else rho,
    )


def _leaves(host: dict, active: bool, num_chunks: int) -> TelemetryLeaves:
    """The run's leaves on the host. The routing and failure-injection
    leaves are zero-filled as the reference fills them with those tiers
    off: per chunk on its scan path, and on its static path the routing
    series only (the fault leaves keep their scalar default)."""
    zeros_c = np.zeros(num_chunks)
    routing = dict(
        router_consults=zeros_c, directory_fetches=zeros_c, mis_routes=zeros_c,
        stale_consults=zeros_c, stale_age_hist=np.zeros((num_chunks, STALE_AGE_BINS)),
    )
    faults = dict(
        unavailable_reads=zeros_c, unavailable_writes=zeros_c, failovers=zeros_c,
        repair_moves=zeros_c, unreachable_frac=zeros_c, wiped_frac=zeros_c,
    ) if active else {}
    return TelemetryLeaves(**host, **routing, **faults)
