"""Trace-driven simulation of the paper's experiment (§8–§9) on one device
(counterpart of ``src/repro/kvsim/simulate.py``): ``run_scenario`` (one
policy over one trace), ``run_experiment`` (the paper's Figure 2/3 grid and
its policy head-to-heads, with 99% CIs over seeds) and
``run_scenario_reference`` (the per-chunk oracle).

The trace is processed in chunks of ``daemon_interval`` requests. Within a
chunk every request sees the replica map frozen at chunk start (the paper's
non-blocking property). Per chunk, in this order:

  1. ``chunk_replay`` prices the chunk's requests against the frozen map
     and folds busy time, latency sum and hit/read counts;
  2. per-node occupancy is sampled on that same map (the running peak
     starts at the initial map's occupancy);
  3. ``record_accesses`` folds the chunk's accesses into the metadata;
  4. on a due tick (``chunk % period == 0``) the policy's sweep
     (``core/policy.py::policy_sweep``; Redynis through ``ownership_sweep``)
     rewrites the map, trimmed to the per-node replica-byte budgets when
     the cluster has a finite ``capacity_bytes``.

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

``run_scenario_reference`` replays chunk by chunk with the kernels' plain
versions on whatever device it is given, the policy through its plain
``decide``, and float64 host accumulators; with telemetry its trace carries
every request's latency (``raw_latency_ms``).

The port covers a materialised trace on one device with routing, faults,
sharding and telemetry attribution off; each of those raises
``NotImplementedError`` naming its later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.metadata import create_store, record_accesses
from repro_torch.core.policy import (
    PolicyContext,
    describe_policy,
    policy_masked_step,
    policy_sweep,
    split_policy,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.chunk_replay.ops import chunk_replay
from repro_torch.kernels.chunk_replay.ref import (
    chunk_latency_ref,
    contention_extra_ms_chunks_ref,
    contention_extra_ms_ref,
)
from repro_torch.kernels.latency_histogram.ref import latency_histogram_ref
from repro_torch.kvsim import telemetry as telemetry_mod
from repro_torch.kvsim.cluster import ClusterConfig, normalize_service
from repro_torch.kvsim.telemetry import (
    STALE_AGE_BINS,
    SimTrace,
    TelemetryConfig,
    TelemetryLeaves,
    build_trace,
    leaves_quantile,
    merge_leaves,
    normalize_telemetry,
)
from repro_torch.kvsim.workload import Trace, WorkloadConfig, generate_trace

__all__ = [
    "SimResult",
    "run_scenario",
    "run_scenario_reference",
    "run_experiment",
    "confidence_interval_99",
]


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


def _check_slice(workload, cluster, trace_mode="materialized", num_shards=1,
                 caller="run_scenario") -> None:
    """Reject what the port does not cover yet, naming the slice that will,
    and a workload that does not fit the cluster."""
    later = [
        (cluster.routing is not None, "ClusterConfig.routing (the routing slice)"),
        (cluster.faults is not None, "ClusterConfig.faults (the failure-injection slice)"),
        (trace_mode == "streamed", "trace_mode='streamed' (the streamed-trace slice)"),
        (num_shards > 1, "num_shards > 1 (the key-sharded engine slice)"),
    ]
    for hit, what in later:
        if hit:
            raise NotImplementedError(f"{caller}: {what} is not ported yet")
    if trace_mode != "materialized":
        raise ValueError(f"{caller}: unknown trace_mode={trace_mode!r}")
    if workload.num_nodes != cluster.num_nodes:
        raise ValueError(
            f"workload has {workload.num_nodes} nodes but cluster topology "
            f"has {cluster.num_nodes}"
        )
    if cluster.rtt is not None and len(cluster.rtt) != cluster.num_nodes:
        raise ValueError(
            f"rtt matrix has {len(cluster.rtt)} rows but num_nodes={cluster.num_nodes}"
        )
    if isinstance(cluster.capacity_bytes, tuple) and len(cluster.capacity_bytes) != cluster.num_nodes:
        raise ValueError(
            f"capacity_bytes has {len(cluster.capacity_bytes)} entries for "
            f"num_nodes={cluster.num_nodes}"
        )


def _prepare(workload, policy, daemon_interval: int, caller: str) -> tuple:
    """The policy resolved, validated and split: ``(static_key, params)``."""
    if policy is None:
        raise ValueError(
            f"{caller}: a policy is required — e.g. RedynisPolicy() or "
            f"StaticPolicy(mode='local')"
        )
    if daemon_interval < 1:
        raise ValueError(f"{caller}: daemon_interval={daemon_interval} must be >= 1")
    policy = policy.resolve(workload.num_nodes)
    policy.validate(workload.num_nodes)
    return split_policy(policy)


def _capacity(cluster: ClusterConfig, device: torch.device) -> torch.Tensor | None:
    """The ``[N]`` budgets on the device, or ``None`` when every budget is
    infinite (the projection stage is skipped: bit-exact Algorithm 3)."""
    return cluster.capacity_vector(device) if cluster.has_finite_capacity else None


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
    static, params = _prepare(workload, policy, daemon_interval, "run_scenario")
    dev = resolve_device(device)
    if trace is None:
        trace = generate_trace(workload, seed, device=dev)
    result, leaves = _simulate(trace.to(dev), cluster, static, params, daemon_interval, tcfg)
    return result if tcfg is None else (result, build_trace(leaves, tcfg))


def _simulate(
    trace: Trace, cluster: ClusterConfig, static, params: dict, daemon_interval: int,
    tcfg: TelemetryConfig | None,
) -> tuple[SimResult, TelemetryLeaves | None]:
    """The engine on the trace's device: the run's ``SimResult`` and, with
    ``tcfg``, its telemetry leaves on the host."""
    dev = trace.keys.device
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
        ctx = PolicyContext(rtt=rtt, object_bytes=obj, capacity_bytes=_capacity(cluster, dev),
                            params=params)
        valid = torch.ones(min(daemon_interval, r), dtype=torch.bool, device=dev)
        busy = torch.zeros(n, **f32)
        lat_sum = torch.zeros((), **f32)
        hits = torch.zeros((), **i64)
        reads = torch.zeros((), **i64)
        pstate = static.init(store, ctx)
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
        return result, None
    at = 7 + 2 * n
    host = {}
    for name, t in series.items():
        host[name] = out[at : at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
    return result, _leaves(host, static.is_active, num_chunks)


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


def _reference_engine(
    trace: Trace, cluster: ClusterConfig, static, params: dict, daemon_interval: int,
    tcfg: TelemetryConfig | None,
) -> tuple[SimResult, TelemetryLeaves | None, np.ndarray | None]:
    """The per-chunk loop of plain PyTorch on the trace's device, the policy
    through its plain ``decide``, float64 accumulators on the host. Returns
    ``(result, telemetry leaves | None, per-request latencies | None)``."""
    dev = trace.keys.device
    keys, nodes, is_read = trace.keys, trace.nodes, trace.is_read
    r = keys.shape[0]
    k, n = trace.natural_node.shape[0], cluster.num_nodes
    if r == 0:
        raise ValueError("run_scenario_reference: the trace holds no request")
    rtt = cluster.rtt_matrix(dev)
    obj = trace.object_bytes.to(torch.float32)
    ctx = PolicyContext(rtt=rtt, object_bytes=obj, capacity_bytes=_capacity(cluster, dev),
                        params=params)
    store = _seed_store(_initial_hosts(trace.natural_node, k, n, static.initial_placement), k, n)
    pstate = static.init(store, ctx)
    contention = _contention_kwargs(cluster, static.read_mode, daemon_interval)
    sc = _replay_scalars(cluster)
    num_chunks = -(-r // daemon_interval)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.to(torch.float64).cpu().numpy()

    busy = np.zeros(n)
    hits = reads = lat_sum = 0.0
    moves = np.zeros(4)  # adds, drops, expiry evictions, capacity evictions
    peak = host(_node_occupancy(store.hosts, obj))
    per_chunk, raw = [], []
    for c in range(num_chunks):
        lo, hi = c * daemon_interval, min((c + 1) * daemon_interval, r)
        ck, cn, cr = keys[lo:hi], nodes[lo:hi], is_read[lo:hi]
        lat, read_hits = chunk_latency_ref(store.hosts, ck, cn, cr, rtt, read_mode=static.read_mode,
                                           **sc)
        rho = None
        if contention is not None:
            extra, rho = contention_extra_ms_ref(
                store.hosts, ck, cn, cr, torch.ones_like(cr), rtt, obj, **contention)
            lat = lat + extra
        busy += host(torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, cn.long(), lat.to(torch.float64)))
        c_lat = float(lat.sum(dtype=torch.float64))
        c_hits, c_reads = float(read_hits.sum()), float(cr.sum())
        lat_sum += c_lat
        hits += c_hits
        reads += c_reads
        occ = host(_node_occupancy(store.hosts, obj))
        peak = np.maximum(peak, occ)
        c_moves = np.zeros(4)
        if static.is_active:
            store = record_accesses(store, ck, cn, now=c)
            if c % static.period == 0:
                plan, pstate, store = policy_sweep(static, pstate, store, c, ctx, fused=False)
                evicted = plan.capacity_evicted
                c_moves = np.array([
                    float(plan.to_add.sum()), float(plan.to_drop.sum()),
                    float((plan.to_drop & plan.expired[:, None]).sum()),
                    0.0 if evicted is None else float(evicted.sum()),
                ])
                moves += c_moves
        if tcfg is not None:
            group = cn.long() * 2 + cr.long()
            hist = latency_histogram_ref(
                lat, group, torch.ones_like(lat), num_groups=2 * n, num_bins=tcfg.num_bins,
                lo=tcfg.lo_ms, hi=tcfg.hi_ms)
            per_chunk.append(dict(
                hist=host(hist), hits=c_hits, reads=c_reads, lat_sum=c_lat, count=float(hi - lo),
                adds=c_moves[0], drops=c_moves[1], expiry_evictions=c_moves[2],
                capacity_evictions=c_moves[3], occupancy=occ,
                load_factor=np.zeros(n) if rho is None else host(rho),
            ))
            raw.append(host(lat))

    result = SimResult(
        throughput_ops_s=r / (float(busy.max()) / 1000.0),
        hit_rate=hits / max(reads, 1.0),
        mean_latency_ms=lat_sum / r,
        node_busy_ms=busy,
        replication_moves=float(moves[0]),
        deletion_moves=float(moves[1]),
        evictions=float(moves[2]),
        capacity_evictions=float(moves[3]),
        peak_occupancy_bytes=peak,
    )
    if tcfg is None:
        return result, None, None
    stacked = {name: np.stack([row[name] for row in per_chunk]) for name in per_chunk[0]}
    return result, _leaves(stacked, True, num_chunks), np.concatenate(raw)


def run_scenario_reference(
    workload: WorkloadConfig,
    cluster: ClusterConfig,
    policy=None,
    seed: int = 0,
    daemon_interval: int = 1000,
    *,
    device: str | torch.device | None = None,
    telemetry: TelemetryConfig | None = None,
) -> SimResult | tuple[SimResult, SimTrace]:
    """The slow-path oracle of :func:`run_scenario`: one chunk at a time in
    plain PyTorch on ``device`` (no kernel, on the card too), the policy
    stepped on the host, float64 accumulators, on ``generate_trace(workload,
    seed)``. The same semantics, so the results agree with
    ``run_scenario``'s to the f32 engine's rounding. With ``telemetry`` it
    returns ``(SimResult, SimTrace)`` and the trace carries
    ``raw_latency_ms``, every request's latency."""
    _check_slice(workload, cluster, caller="run_scenario_reference")
    tcfg = normalize_telemetry(telemetry)
    static, params = _prepare(workload, policy, daemon_interval, "run_scenario_reference")
    dev = resolve_device(device)
    result, leaves, raw = _reference_engine(generate_trace(workload, seed, device=dev), cluster,
                                            static, params, daemon_interval, tcfg)
    if tcfg is None:
        return result
    return result, build_trace(leaves, tcfg, raw_latency_ms=raw)


def confidence_interval_99(samples: np.ndarray) -> tuple:
    """Mean ± 99% CI half-width (normal approximation, the paper's error
    bars over repeated iterations). ``samples`` is per seed: an ``[S]``
    vector of scalars, or an ``[S, ...]`` stack reduced along axis 0 (then
    the mean and half-width are arrays of the trailing shape). Scalars
    return plain floats."""
    samples = np.asarray(samples, dtype=np.float64)
    s = samples.shape[0]
    mean = np.mean(samples, axis=0)
    if s < 2:
        ci = np.zeros_like(mean)
    else:
        ci = 2.576 * (np.std(samples, axis=0, ddof=1) / np.sqrt(s))
    if mean.ndim == 0:
        return float(mean), float(ci)
    return mean, ci


def _stack_leaves(leaves: list) -> TelemetryLeaves:
    """Per-seed leaves stacked on a leading seed axis."""
    return TelemetryLeaves(*(np.stack([np.asarray(x) for x in field]) for field in zip(*leaves)))


def run_experiment(
    read_fractions: tuple[float, ...] = (1.0, 0.9, 0.75, 0.5),
    skewed: bool = False,
    iterations: int = 5,
    num_requests: int = 100_000,
    cluster: ClusterConfig | None = None,
    engine: str = "scan",
    daemon_interval: int = 1000,
    policies=None,
    telemetry: TelemetryConfig | None = None,
    *,
    device: str | torch.device | None = None,
    traces=None,
    **workload_kwargs,
) -> dict:
    """The paper's Figure 2/3 grid, and any policy head-to-head, with 99%
    CIs over seeds ``0 .. iterations - 1``.

    policies: required list of policy instances. The result maps each
        policy's label (``describe_policy``) to its read-fraction rows under
        ``"policies"``; a row carries ``throughput`` and ``ci99``,
        ``hit_rate`` (the seed mean) and ``hit_rate_ci99``,
        ``mean_latency_ms`` and the per-seed ``SimResult``s (``"results"``).
    engine: ``"scan"`` runs :func:`run_scenario`'s engine (the kernels on
        the card, their plain versions on the CPU); ``"reference"`` runs
        :func:`run_scenario_reference`'s loop.
    telemetry: with an enabled :class:`TelemetryConfig` each row also has
        ``p99_latency_ms`` with its ``p99_ci99`` band (over the per-seed
        P99s), the ``quantiles`` block and the seed-merged ``trace``
        (histograms summed over seeds).
    device: where the runs go (``None`` means CUDA).
    traces: optional ``(WorkloadConfig, seed) -> Trace``, the trace of
        each seed (``run_scenario``'s ``trace=``); by default
        ``generate_trace(workload, seed)`` on the device.

    Seeds and policies run as a Python loop of engine calls, each seed's
    trace shared by every policy; ``"num_batched_calls"`` counts the
    engine calls (0 for the reference engine).
    """
    if cluster is None:
        cluster = ClusterConfig()
    workload_kwargs.setdefault("num_nodes", cluster.num_nodes)
    if engine not in ("scan", "reference"):
        raise ValueError(f"unknown engine {engine!r}")
    tcfg = normalize_telemetry(telemetry)
    if policies is None:
        raise ValueError(
            "run_experiment: policies is required — e.g. policies=["
            "StaticPolicy(mode='remote'), RedynisPolicy()]"
        )
    n = cluster.num_nodes
    named = []
    for pol in policies:
        pol = pol.resolve(n)
        pol.validate(n)
        named.append((describe_policy(pol), split_policy(pol)))
    labels = [label for label, _ in named]
    if len(set(labels)) != len(labels):
        raise ValueError(
            f"duplicate policy labels in {labels}; vary at least one hyperparameter per entry"
        )
    if daemon_interval < 1:
        raise ValueError(f"run_experiment: daemon_interval={daemon_interval} must be >= 1")
    dev = resolve_device(device)
    engine_fn = _simulate if engine == "scan" else _reference_engine

    out: dict = {
        "skewed": skewed,
        "read_fractions": list(read_fractions),
        "policies": {label: [] for label in labels},
        "num_batched_calls": 0,
    }
    for rf in read_fractions:
        wl = WorkloadConfig(num_requests=num_requests, read_fraction=rf, skewed=skewed,
                            **workload_kwargs)
        _check_slice(wl, cluster, caller="run_experiment")
        runs = [[] for _ in named]  # per policy: (SimResult, leaves) per seed
        for seed in range(iterations):
            trace = generate_trace(wl, seed, device=dev) if traces is None else traces(wl, seed)
            trace = trace.to(dev)
            for row, (_, (static, params)) in zip(runs, named):
                row.append(engine_fn(trace, cluster, static, params, daemon_interval, tcfg)[:2])
                out["num_batched_calls"] += engine == "scan"
            del trace
        for label, row in zip(labels, runs):
            results = [res for res, _ in row]
            mean, ci = confidence_interval_99(np.array([x.throughput_ops_s for x in results]))
            hit_mean, hit_ci = confidence_interval_99(np.array([x.hit_rate for x in results]))
            entry = {
                "read_fraction": rf,
                "throughput": mean,
                "ci99": ci,
                "hit_rate": hit_mean,
                "hit_rate_ci99": hit_ci,
                "mean_latency_ms": float(np.mean([x.mean_latency_ms for x in results])),
                "results": results,
            }
            if tcfg is not None:
                leaves = [lv for _, lv in row]
                p99_mean, p99_ci = confidence_interval_99(
                    np.array([leaves_quantile(lv, tcfg, 0.99) for lv in leaves]))
                merged = build_trace(merge_leaves(_stack_leaves(leaves)), tcfg)
                entry["p99_latency_ms"] = p99_mean
                entry["p99_ci99"] = p99_ci
                entry["quantiles"] = merged.tail_summary()
                entry["trace"] = merged
            out["policies"][label].append(entry)
    return out
