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

Static policies never change the map, so with routing and faults off
their whole trace is replayed in one ``chunk_replay`` launch: the same sums, re-associated, as the
reference's static fast path does. All accumulators stay on the device and
are read back once at the end; f32 aggregates accumulate in f32 in chunk
order, as the reference's scan carry does.

Contention (``ClusterConfig.service``, an enabled ``ServiceConfig``): before
step 1 each chunk runs the M/M/1 pre-pass on its frozen map
(``contention_extra_ms_ref``), and the replay adds each request's wait as
``extra_ms``. On the static path the pre-pass runs over all chunks at once.

Failure injection (``ClusterConfig.faults``, a ``FaultConfig`` lowered by
``faults.compile_schedule`` to host-side ``[C, N]`` availability and crash
timelines): at chunk start a crash wipes the crashed nodes' copies from the
map, ``fault_extra_ms_ref`` rules each request unavailable or served and
prices the write failover, and the chunk is replayed on the live map
``hosts & avail`` with the served requests as ``valid``. The sweep sees
``PolicyContext.avail``; re-seeded copies of keys that had lost every live
copy count as ``repair_moves``. The mean latency is over served requests.

Routing (``ClusterConfig.routing``, a ``RoutingConfig``): each chunk
consults the router caches against the published, possibly lagged,
ownership view (``kvsim.routing``) and prices mis-routes and directory
fetches (``routing_extra_split_ref``); after the replay the caches refresh
and the daemon's commit publishes. With faults on, the publish goes through
a ring of at least one slot, frozen while the directory home node is down.

The surcharges compose as the reference composes them, one f32 add each:
``route = detour + fetch``, ``extra = route + contention``, ``extra =
fault + extra``. With routing or faults on, static policies replay chunk by
chunk too (router caches evolve, crashes change their map).

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

Cost attribution and the flight recorder (``TelemetryConfig(attribution=
AttributionConfig(), flight=FlightRecorderConfig())``): each chunk is
priced once more through ``chunk_components_ref`` on the same frozen,
availability-masked map with the same contention, detour and fetch
surcharges, masked by the served requests; one ``latency_histogram``
launch folds its ``[8, 2N, Ba]`` component histograms, an f64 row sum its
component sums, and the flight recorder gathers its sampled requests'
identities and components (positions for every chunk drawn before the
loop). On the static path the same runs over the whole trace at once.
With both off the engine runs the code it ran without them.

Streamed traces (``trace_mode="streamed"``): the per-key state is drawn
once and each chunk's requests are drawn on the device at chunk start
(``trace_window``, one launch a chunk on the card), so no ``[R]`` buffer
exists; the windows equal the materialised trace's slices, so every result
does too. A streamed run always takes the chunk loop.

Spans (``repro_torch.obs``): while a ``torch.profiler`` session collects,
``run_scenario`` marks its stages (each chunk and its pre-passes, replay,
occupancy, ``record_accesses`` and policy step, or the static replay) and
counts its chunks and sweeps; nothing else changes, and with no session a
site costs one global read.

``run_scenario_reference`` replays chunk by chunk with the kernels' plain
versions on whatever device it is given, the policy through its plain
``decide``, and float64 host accumulators; with telemetry its trace carries
every request's latency (``raw_latency_ms``) and, with attribution or the
flight recorder, every request's components (``raw_components``).

Key sharding (``num_shards=S > 1``, a ``ShardSpec``): SPMD over an
initialised ``torch.distributed`` group of exactly ``S`` ranks
(``spmd.run_ranks`` starts one), each calling ``run_scenario`` with the
same arguments and getting the same global result. Rank ``i`` holds global
keys ``[i * kps, (i + 1) * kps)``, ``kps = ceil(K / S)``; the last block is
padded with dead keys (never live, never hosted, zero bytes). Every rank
draws the whole trace (or every window) from the seed and replays only the
requests for its own keys (``mine = key // kps == rank``, the key made
local, the rest masked out of ``valid``), so a sharded run always takes the
chunk loop. The cross-rank folds sit where the reference has its ``psum``
(all an ``all_reduce(SUM)``, ``spmd``): the occupancy sample before the
running peak, the contention demand fold (in f64, rounded after the fold),
the router caches' admission threshold, the fault tier's unreachable and
wiped key counts, and after the loop the aggregates and the telemetry
series (``telemetry.psum_leaves``). Counts, histograms and the attribution
sums equal the one-rank run's; the f32 sums (busy, latency, occupancy)
re-associate across ranks. ``topk`` (a global argsort) and finite
``capacity_bytes`` (a global projection sort) are rejected sharded, as in
the reference.
"""

from __future__ import annotations

import enum
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.metadata import create_store, record_accesses
from repro_torch.core.policy import (
    PolicyContext,
    describe_policy,
    policy_masked_step,
    policy_sweep,
    publish_mask,
    split_policy,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.chunk_replay.ops import chunk_replay
from repro_torch.kernels.chunk_replay.ref import (
    NUM_COMPONENTS,
    SLAB_ROWS,
    chunk_components_ref,
    chunk_latency_ref,
    contention_extra_ms_chunks_ref,
    contention_extra_ms_ref,
    fault_extra_ms_ref,
    routing_extra_split_ref,
)
from repro_torch.kernels.latency_histogram.ref import latency_histogram_ref
from repro_torch.kernels.trace_window.ops import trace_window
from repro_torch.kernels.trace_window.ref import WindowParams
from repro_torch.kvsim import prng
from repro_torch.kvsim import telemetry as telemetry_mod
from repro_torch.kvsim.cluster import ClusterConfig, normalize_service
from repro_torch.kvsim.faults import compile_schedule, normalize_faults
from repro_torch.kvsim.routing import (
    consult_probe,
    init_router_state,
    normalize_routing,
    publish_commit,
    published_view,
    router_cache_update,
    router_of,
    stale_age_fold,
)
from repro_torch.kvsim.telemetry import (
    STALE_AGE_BINS,
    SimTrace,
    TelemetryConfig,
    TelemetryLeaves,
    build_trace,
    leaves_quantile,
    merge_leaves,
    normalize_telemetry,
    psum_leaves,
)
from repro_torch.kvsim.workload import (
    Trace,
    WorkloadConfig,
    generate_key_state,
    generate_trace,
    window_params,
)
from repro_torch.spmd import all_sum, rank_of, world_group

__all__ = [
    "TRACE_MODES",
    "Scenario",
    "ShardSpec",
    "SimResult",
    "run_scenario",
    "run_scenario_reference",
    "run_experiment",
    "confidence_interval_99",
]

TRACE_MODES = ("materialized", "streamed")
FLIGHT_SEED = 0x9E37  # PRNGKey of the flight recorder's reservoir offsets


class Scenario(enum.Enum):
    """The legacy scenario spelling. Passing one where a policy belongs
    raises, naming the policy that replaces it."""

    LOCAL = "local"
    REMOTE = "remote"
    OPTIMIZED = "optimized"
    REPLICATED = "replicated"


def _reject_scenario(caller: str, policy) -> None:
    """Raise the reference's error for a ``Scenario`` passed as a policy."""
    if isinstance(policy, Scenario):
        repl = (
            "RedynisPolicy()" if policy is Scenario.OPTIMIZED
            else f"StaticPolicy(mode={policy.value!r})"
        )
        raise ValueError(
            f"{caller}: the legacy scenario= spelling was removed (its "
            f"deprecation window is over); pass policy={repl} instead"
        )


class ShardSpec(NamedTuple):
    """Key sharding of the engine (the reference's ``ShardSpec``, with a
    ``torch.distributed`` group where it has a mesh axis name). ``group=None``
    (the default) is the one-rank program: no collective, no request
    masking. With a group of ``num_shards`` ranks each rank holds a block of
    ``ceil(K / num_shards)`` keys; ``pad`` dead keys fill the last block."""

    group: Any = None
    num_shards: int = 1
    pad: int = 0

    @property
    def active(self) -> bool:
        return self.group is not None and self.num_shards > 1


class _Stream(NamedTuple):
    """A streamed trace: the per-key state and what draws any window."""

    natural_node: torch.Tensor  # [K] int32
    object_bytes: torch.Tensor  # [K] f32
    params: WindowParams
    num_requests: int


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
    # Routing tier (zero with ClusterConfig.routing off).
    router_consults: float = 0.0  # directory consults
    directory_fetches: float = 0.0  # cache misses (home-node round trips)
    mis_routes: float = 0.0  # consults detoured by a stale ownership view
    stale_consults: float = 0.0  # consults that hit a stale cache entry
    # Failure injection (zero with ClusterConfig.faults off). With faults on,
    # hit_rate and mean_latency_ms cover served requests only.
    unavailable_reads: float = 0.0  # reads refused (origin down / no live copy)
    unavailable_writes: float = 0.0  # writes refused (origin node down)
    failovers: float = 0.0  # writes relayed through a stand-in master
    repair_moves: float = 0.0  # re-replications of copies lost to failures


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


def _seed_store(hosts: torch.Tensor, num_keys: int, num_nodes: int,
                real: torch.Tensor | None = None):
    """Metadata layer seeded with the initial placement. ``home`` stays
    zero: only the routing and failure-injection slices read it. ``real``
    (a sharded rank's ``[K]`` mask of keys that exist) leaves the dead keys
    of the padded last block unhosted and not live."""
    dev = hosts.device
    live = torch.ones(num_keys, dtype=torch.bool, device=dev) if real is None else real
    return create_store(num_keys, num_nodes, dev)._replace(hosts=hosts & live[:, None], live=live)


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


def _routing_kwargs(cluster: ClusterConfig, num_keys: int) -> dict | None:
    """The routing tier's resolved knobs, or ``None`` when the cluster has
    no enabled ``RoutingConfig``. ``num_routers = 0`` resolves to one
    router a node; a ``cache_entries`` at or beyond the keyspace is the
    unbounded cache (0), which never evicts."""
    routing = normalize_routing(cluster.routing)
    if routing is None:
        return None
    if routing.home_node >= cluster.num_nodes:
        raise ValueError(
            f"routing.home_node={routing.home_node} is not a node index "
            f"(num_nodes={cluster.num_nodes})"
        )
    if routing.num_routers > cluster.num_nodes:
        raise ValueError(
            f"routing.num_routers={routing.num_routers} exceeds "
            f"num_nodes={cluster.num_nodes} (routers are consulted per "
            f"requesting node, node x -> router x % R)"
        )
    return dict(
        num_routers=routing.num_routers or cluster.num_nodes,
        cache_entries=0 if routing.cache_entries >= num_keys else routing.cache_entries,
        publish_lag_chunks=routing.publish_lag_chunks,
        home_node=routing.home_node,
        decay=routing.decay,
    )


def _fault_kwargs(cluster: ClusterConfig, num_chunks: int) -> dict | None:
    """The fault schedule's ``[C, N]`` ``avail`` and ``crash`` timelines as
    host-side numpy, or ``None`` when the cluster has no enabled
    ``FaultConfig``. ``compile_schedule`` rejects a chunk with no live
    node."""
    faults = normalize_faults(cluster.faults)
    if faults is None:
        return None
    avail, crash = compile_schedule(
        faults, num_nodes=cluster.num_nodes, num_chunks=num_chunks,
        zone_of=cluster.zone_of, region_of=cluster.region_of,
    )
    return dict(avail=avail, crash=crash)


def _check_slice(workload, cluster, trace_mode="materialized", caller="run_scenario") -> None:
    """Reject a trace mode the engine does not know and a workload that
    does not fit the cluster."""
    if trace_mode not in TRACE_MODES:
        raise ValueError(f"{caller}: trace_mode={trace_mode!r}; expected one of {TRACE_MODES}")
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
    for name in ("zone_of", "region_of"):
        labels = getattr(cluster, name)
        if labels is not None and len(labels) != cluster.num_nodes:
            raise ValueError(
                f"{name} labels {len(labels)} nodes but num_nodes={cluster.num_nodes}"
            )


def _check_scale_out(caller: str, cluster: ClusterConfig, static, num_shards: int) -> None:
    """Reject a shard count below one, and what needs a global sort when
    sharded (as the reference does)."""
    if num_shards < 1:
        raise ValueError(f"{caller}: num_shards={num_shards} must be >= 1")
    if num_shards == 1:
        return
    if getattr(type(static), "name", "") == "topk":
        raise ValueError(
            f"{caller}: the topk policy ranks keys with a GLOBAL argsort "
            "and is not supported sharded (num_shards > 1)"
        )
    if cluster.has_finite_capacity:
        raise ValueError(
            f"{caller}: finite capacity_bytes needs the global projection "
            "sort and is not supported sharded (num_shards > 1)"
        )


def _prepare(workload, policy, daemon_interval: int, caller: str) -> tuple:
    """The policy resolved, validated and split: ``(static_key, params)``."""
    _reject_scenario(caller, policy)
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


@obs.scenario()
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
    ``trace_mode="streamed"`` draws each chunk's requests at chunk start
    instead (the same results, no ``[R]`` buffer; it takes no ``trace``).
    ``device=None`` runs on CUDA and raises without a card; the CPU runs only
    when asked for (``device="cpu"``), through the kernels' plain versions.
    With an enabled ``telemetry`` the call returns ``(SimResult, SimTrace)``.

    ``num_shards=S > 1`` shards the key axis over the initialised
    ``torch.distributed`` group, which must hold exactly ``S`` ranks, each
    making this call with the same arguments (see the module docstring);
    every rank returns the same global result.
    """
    _check_slice(workload, cluster, trace_mode)
    tcfg = normalize_telemetry(telemetry)
    static, params = _prepare(workload, policy, daemon_interval, "run_scenario")
    _check_scale_out("run_scenario", cluster, static, num_shards)
    shard = ShardSpec()
    if num_shards > 1:
        kps = -(-workload.num_keys // num_shards)
        shard = ShardSpec(world_group(num_shards, "run_scenario"), num_shards,
                          kps * num_shards - workload.num_keys)
    dev = resolve_device(device)
    if trace_mode == "streamed":
        if trace is not None:
            raise ValueError("run_scenario: trace_mode='streamed' draws its own trace; pass no trace=")
        natural, sizes = generate_key_state(workload, seed, device=dev)
        source = _Stream(natural, sizes, window_params(workload, seed), workload.num_requests)
    else:
        if trace is None:
            trace = generate_trace(workload, seed, device=dev)
        source = trace.to(dev)
    result, leaves = _simulate(source, cluster, static, params, daemon_interval, tcfg, shard)
    return result if tcfg is None else (result, build_trace(leaves, tcfg))


def _flight_positions(fcfg, num_chunks: int, chunk_size: int, device: torch.device) -> torch.Tensor:
    """In-chunk sample offsets ``[C, S]`` int64 of every chunk: ``"stride"``
    the same equally spaced offsets each chunk; ``"reservoir"``
    ``randint(fold_in(PRNGKey(0x9E37), chunk), (S,), 0, chunk_size)``, all
    chunks' keys and draws in one batch."""
    s = fcfg.samples_per_chunk
    if fcfg.mode == "stride":
        stride = max(chunk_size // s, 1)
        row = (torch.arange(s, dtype=torch.int64, device=device) * stride) % chunk_size
        return row.expand(num_chunks, s)
    k0, k1 = prng.fold_in(prng.prng_key(FLIGHT_SEED),
                          torch.arange(num_chunks, dtype=torch.int64, device=device))
    pos = torch.arange(s, dtype=torch.int64, device=device)[None, :]
    return prng.randint((k0[:, None], k1[:, None]), pos, 0, chunk_size).to(torch.int64)


def _flight_total(scomps: torch.Tensor) -> torch.Tensor:
    """The flight recorder's total: the component rows (leading axis) added
    one after another, as the reference's compiled sum adds them."""
    total = scomps[0]
    for row in scomps[1:]:
        total = total + row
    return total


def _flight_sample(idx, base: int, keys, nodes, is_read, served, comps, router, key_base: int = 0):
    """Flight records ``(meta [..., 5] int32, vals [..., 9] f32)`` of the
    rows ``idx`` (any shape) of ``keys``, ``nodes``, ``is_read`` and
    ``comps [8, rows]``, whose row 0 is trace position ``base``; an index
    past the rows or an unserved request (``served`` ``None``: all served)
    leaves its slot zero, valid bit clear. ``router`` is ``[rows]`` or
    ``None``; ``key_base`` makes a sharded rank's local keys global."""
    rows = keys.shape[0]
    jc = idx.clamp_max(rows - 1)
    own = idx < rows
    if served is not None:
        own = own & served[jc]
    rcol = torch.full_like(jc, -1) if router is None else router[jc].long()
    meta = torch.stack([base + idx, keys[jc].long() + key_base, nodes[jc].long(), rcol,
                        is_read[jc].long() | 2], dim=-1)
    meta = torch.where(own[..., None], meta, torch.zeros((), dtype=torch.int64, device=jc.device))
    scomps = torch.where(own[None], comps[:, jc], torch.zeros((), dtype=torch.float32,
                                                             device=jc.device))
    vals = torch.cat([_flight_total(scomps)[None], scomps]).movedim(0, -1)
    return meta.to(torch.int32), vals


def _simulate(
    trace: Trace | _Stream, cluster: ClusterConfig, static, params: dict, daemon_interval: int,
    tcfg: TelemetryConfig | None, shard: ShardSpec | None = None,
) -> tuple[SimResult, TelemetryLeaves | None]:
    """The engine on the trace's device: the run's ``SimResult`` and, with
    ``tcfg``, its telemetry leaves on the host. ``trace`` is a materialised
    ``Trace`` or a ``_Stream``. With an active ``shard`` this rank holds
    its block of the key axis and the results are the group's (see the
    module docstring)."""
    dev = trace.natural_node.device
    streamed = isinstance(trace, _Stream)
    if streamed:
        keys = nodes = is_read = None
        r = trace.num_requests
    else:
        keys, nodes, is_read = trace.keys, trace.nodes, trace.is_read
        r = keys.shape[0]
    k, n = trace.natural_node.shape[0], cluster.num_nodes
    if r == 0:
        raise ValueError("run_scenario: the trace holds no request")
    rtt = cluster.rtt_matrix(dev)
    obj = trace.object_bytes.to(torch.float32)
    natural = trace.natural_node
    scalars = _replay_scalars(cluster)
    read_mode = static.read_mode
    shard = shard or ShardSpec()
    group = shard.group if shard.active else None
    real_keys = k  # keys that exist: the padded block's dead keys are not counted
    kps, rank, base, real = k, 0, 0, None
    if shard.active:
        # This rank's block of keys [base, base + kps); the last block's
        # tail past the real keys is dead.
        kps = (k + shard.pad) // shard.num_shards
        rank = rank_of(group)
        base = rank * kps
        pad_keys = torch.zeros(shard.pad, dtype=torch.int32, device=dev)
        natural = torch.cat([natural, pad_keys])[base : base + kps]
        obj = torch.cat([obj, pad_keys.float()])[base : base + kps]
        real = base + torch.arange(kps, device=dev) < real_keys
        k = kps

    store = _seed_store(
        _initial_hosts(natural, k, n, static.initial_placement), k, n, real
    )
    peak = all_sum(_node_occupancy(store.hosts, obj), group)
    f32 = dict(dtype=torch.float32, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    moves = torch.zeros(4, **i64)  # adds, drops, expiry evictions, capacity
    # consults, fetches, mis-routes, stale consults; unavailable reads and
    # writes, failovers, repair moves
    tiers = torch.zeros(8, **i64)
    contention = _contention_kwargs(cluster, read_mode, daemon_interval)
    bins = {} if tcfg is None else dict(num_bins=tcfg.num_bins, lo=tcfg.lo_ms, hi=tcfg.hi_ms)
    num_chunks = -(-r // daemon_interval)
    routing = _routing_kwargs(cluster, real_keys)
    fault = _fault_kwargs(cluster, num_chunks)
    acfg = None if tcfg is None else tcfg.attribution
    fcfg = None if tcfg is None else tcfg.flight
    fpos = None if fcfg is None else _flight_positions(fcfg, num_chunks, daemon_interval, dev)
    loop = static.is_active or routing is not None or fault is not None or streamed or shard.active

    if not loop:
        # A frozen map makes the whole request path loop-invariant: one
        # launch over the whole trace.
        with obs.span("static_replay"):
            obs.count("chunks", num_chunks)
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
                if acfg is not None or fcfg is not None:
                    series.update(_static_attribution(
                        store.hosts, keys, nodes, is_read, rtt, read_mode, scalars, extra, acfg,
                        fpos, daemon_interval, n))
    else:
        ctx = PolicyContext(rtt=rtt, object_bytes=obj, capacity_bytes=_capacity(cluster, dev),
                            params=params)
        valid = torch.ones(min(daemon_interval, r), dtype=torch.bool, device=dev)
        busy = torch.zeros(n, **f32)
        lat_sum = torch.zeros((), **f32)
        hits = torch.zeros((), **i64)
        reads = torch.zeros((), **i64)
        no_moves = torch.zeros(4, **i64)
        pstate = static.init(store, ctx) if static.is_active else None
        occ = peak  # a static map's occupancy, re-sampled where the map can change
        resample = static.is_active or fault is not None
        if routing is not None:
            lag = routing["publish_lag_chunks"]
            rstate = init_router_state(
                store.hosts, num_routers=routing["num_routers"],
                cache_entries=routing["cache_entries"], publish_lag_chunks=lag,
                active=static.is_active, force_ring=fault is not None,
            )
        if fault is not None:
            avail_np, crash_np = fault["avail"], fault["crash"]
            avail_all = torch.from_numpy(avail_np).to(dev)
            crash_all = torch.from_numpy(crash_np).to(dev)
            wiped = torch.zeros(k, dtype=torch.bool, device=dev)
            # The reference's compiled program divides by the key count as
            # a multiply by its f32 reciprocal.
            inv_keys = torch.full((), float(np.float32(1.0) / np.float32(real_keys)), **f32)
        per_chunk = []  # dicts of each chunk's device tensors, stacked at the end
        for c in obs.each("chunk", range(num_chunks)):
            lo, hi = c * daemon_interval, min((c + 1) * daemon_interval, r)
            obs.count("chunks")
            if streamed:
                # The chunk's window, drawn at chunk start; a final window
                # past R is cut to its valid rows.
                ck, cn, cr = (x[: hi - lo] for x in trace_window(
                    lo, daemon_interval, trace.params, trace.natural_node))
            else:
                ck, cn, cr = keys[lo:hi], nodes[lo:hi], is_read[lo:hi]
            cv = valid[: hi - lo]
            if shard.active:
                # This rank replays the requests for its own keys only.
                mine = ck // kps == rank
                ck = torch.where(mine, ck - base, 0)
                cv = cv & mine
            row = {}
            served, hosts_eff, extra = cv, store.hosts, None
            avail_c = cont = detour = fetch = None
            if fault is not None:
                with obs.span("fault_prepass"):
                    avail_c = avail_all[c]
                    if crash_np[c].any():
                        # A crash wipes the crashed nodes' copies at chunk start.
                        post = store.hosts & ~crash_all[c][None, :]
                        wiped = wiped | (store.hosts.any(dim=-1) & ~post.any(dim=-1))
                        store = store._replace(hosts=post)
                    f_extra, unavail, failover = fault_extra_ms_ref(
                        store.hosts, ck, cn, cr, cv, avail_c, rtt, read_mode=read_mode,
                        master=scalars["master"], xfer_write_ms=scalars["xfer_write_ms"],
                        wiped=wiped,
                    )
                    served = cv & ~unavail
                    if not avail_np[c].all():
                        hosts_eff = store.hosts & avail_c[None, :]
            if routing is not None:
                with obs.span("routing_prepass"):
                    # Routers price against the published view; true serving is
                    # on the live map, and refused requests consult nothing.
                    pub_hosts, pub_ver = published_view(rstate, store.hosts, c,
                                                        publish_lag_chunks=lag)
                    rb = router_of(cn, routing["num_routers"])
                    ent_cached, fresh, age = consult_probe(rstate, rb, ck)
                    detour, fetch, consult, fetched, stale, mis = routing_extra_split_ref(
                        hosts_eff, pub_hosts, ent_cached, fresh, ck, cn, cr, served, rtt,
                        read_mode=read_mode, home_node=routing["home_node"],
                    )
                    extra = detour + fetch
            rho = None
            if contention is not None:
                with obs.span("contention_prepass"):
                    cont, rho = contention_extra_ms_ref(hosts_eff, ck, cn, cr, served, rtt, obj,
                                                        **contention, group=group)
                    extra = cont if extra is None else extra + cont
            if fault is not None:
                extra = f_extra if extra is None else f_extra + extra
            if acfg is not None or fcfg is not None:
                with obs.span("attribution_components"):
                    comps = chunk_components_ref(
                        hosts_eff, ck, cn, cr, rtt, read_mode=read_mode, contention_ms=cont,
                        routing_detour_ms=detour, directory_fetch_ms=fetch, avail=avail_c,
                        **scalars,
                    )
                    comps = torch.where(served[None, :], comps, torch.zeros((), **f32))
                    if acfg is not None:
                        with obs.span("attribution_fold"):
                            row["attr_hist"] = telemetry_mod.attribution_chunk_hist(
                                comps, (cn * 2 + cr.to(torch.int32)).to(torch.int32),
                                served.to(torch.float32), acfg, n)
                            # f32 after the fold
                            row["attr_sum"] = comps.sum(dim=1, dtype=torch.float64)
                    if fcfg is not None:
                        with obs.span("flight_recorder"):
                            row["flight_meta"], row["flight_vals"] = _flight_sample(
                                fpos[c], lo, ck, cn, cr, served, comps,
                                None if routing is None else rb, key_base=base)
            with obs.span("chunk_replay"):
                d_busy, d_lat, d_hits, d_reads, d_count, hist = chunk_replay(
                    hosts_eff, ck, cn, cr, served, rtt, read_mode=read_mode,
                    extra_ms=extra, **bins, **scalars,
                )
                busy = busy + d_busy
                lat_sum = lat_sum + d_lat
                hits += d_hits
                reads += d_reads
            if fault is not None:
                with obs.span("fault_counters"):
                    unreach = (store.hosts.any(dim=-1) & ~hosts_eff.any(dim=-1)) | wiped
                    dark = all_sum(torch.stack([unreach.sum(), wiped.sum()]), group)
                    row["fracs"] = dark.to(torch.float32) * inv_keys
            if resample:
                with obs.span("occupancy"):
                    occ = all_sum(_node_occupancy(store.hosts, obj), group)
                    peak = torch.maximum(peak, occ)
            if routing is not None:
                row["routing"] = torch.stack([consult.sum(), fetched.sum(), mis.sum(), stale.sum()])
                row["stale_age_hist"] = stale_age_fold(age, stale)
                rstate = router_cache_update(
                    rstate, rb, ck, consult, pub_ver,
                    cache_entries=routing["cache_entries"], decay=routing["decay"], group=group,
                )
            stats, d_rep = no_moves, torch.zeros((), **i64)
            if static.is_active:
                with obs.span("record_accesses"):
                    # Users of a down origin are offline and leave no demand.
                    demand = cv if fault is None else cv & avail_c[cn.long()]
                    store = record_accesses(store, ck, cn, now=c, valid=demand)
                prev_hosts = store.hosts
                step_ctx = ctx if fault is None else ctx._replace(avail=avail_c)
                stats, pstate, store = policy_masked_step(
                    static, pstate, store, c, c % static.period == 0, step_ctx
                )
                stats = torch.stack(stats)
                moves += stats
                if fault is not None:
                    with obs.span("repair_accounting"):
                        # Copies the sweep made of keys that had lost every live
                        # copy are repairs; a wiped key heals once a live node
                        # holds it again.
                        added = store.hosts & ~prev_hosts
                        lost_live = (prev_hosts.any(dim=-1)
                                     & ~(prev_hosts & avail_c[None, :]).any(dim=-1))
                        d_rep = (added & (wiped | lost_live)[:, None]).sum()
                        wiped = wiped & ~(store.hosts & avail_c[None, :]).any(dim=-1)
                if routing is not None:
                    with obs.span("publish"):
                        rstate = publish_commit(
                            rstate, publish_mask(prev_hosts, store.hosts), store.hosts, c,
                            publish_lag_chunks=lag,
                            daemon_up=(None if fault is None
                                       else bool(avail_np[c, routing["home_node"]])),
                        )
            if fault is not None:
                row["fault"] = torch.stack([(unavail & cr).sum(), (unavail & ~cr).sum(),
                                            failover.sum(), d_rep])
                tiers[4:] += row["fault"]
            if routing is not None:
                tiers[:4] += row["routing"]
            if tcfg is not None:
                row.update(hist=hist, hits=d_hits, reads=d_reads, lat_sum=d_lat, count=d_count,
                           stats=stats, occupancy=occ, rho=rho)
                per_chunk.append(row)
        if group is not None:
            # The group's aggregates from this rank's partial sums.
            busy, lat_sum = all_sum(torch.cat([busy, lat_sum[None]]), group).split([n, 1])
            lat_sum = lat_sum[0]
            counts = all_sum(torch.cat([hits[None], reads[None], moves, tiers]), group)
            hits, reads, moves, tiers = counts.split([1, 1, 4, 8])
            hits, reads = hits[0], reads[0]
        if tcfg is not None:
            series = psum_leaves(_loop_series(per_chunk, n), group)
            if "attr_sum" in series:
                series["attr_sum"] = series["attr_sum"].float()

    # f32 epilogue as in the reference, then ONE device-to-host copy.
    # Divisors are tensors: CUDA turns division by a Python scalar into a
    # multiply by its reciprocal, which is not the reference's f32 division.
    r_f = torch.full((), float(r), **f32)
    tput = r_f / (busy.max() / torch.full((), 1000.0, **f32))
    hit_rate = hits.to(torch.float32) / torch.clamp_min(reads.to(torch.float32), 1.0)
    if fault is None:
        mean_lat = lat_sum / r_f
    else:  # over served requests; throughput still counts every attempt
        served_r = r_f - tiers[4].to(torch.float32) - tiers[5].to(torch.float32)
        mean_lat = lat_sum / torch.clamp_min(served_r, 1.0)
    parts = [torch.stack([tput, hit_rate, mean_lat]), busy, moves, peak, tiers]
    if tcfg is not None:
        parts += list(series.values())
    out = torch.cat([p.to(torch.float64).reshape(-1) for p in parts]).cpu().numpy()
    result = SimResult(
        float(out[0]), float(out[1]), float(out[2]), out[3 : 3 + n],
        *(float(x) for x in out[3 + n : 7 + n]), out[7 + n : 7 + 2 * n],
        *(float(x) for x in out[7 + 2 * n : 15 + 2 * n]),
    )
    if tcfg is None:
        return result, None
    at = 15 + 2 * n
    host = {}
    for name, t in series.items():
        host[name] = out[at : at + t.numel()].reshape(tuple(t.shape))
        at += t.numel()
    return result, _leaves(host, loop, num_chunks)


def _loop_series(per_chunk: list, n: int) -> dict:
    """Stack the chunk loop's per-chunk device tensors into the ``[C, ...]``
    series (still on the device)."""
    col = lambda name: [row[name] for row in per_chunk]  # noqa: E731
    stats = torch.stack(col("stats"))  # [C, 4]
    rho = col("rho")
    load = (
        torch.zeros((len(rho), n), dtype=torch.float32, device=stats.device)
        if rho[0] is None else torch.stack(rho)
    )
    series = dict(
        hist=torch.stack(col("hist")), hits=torch.stack(col("hits")),
        reads=torch.stack(col("reads")), lat_sum=torch.stack(col("lat_sum")),
        count=torch.stack(col("count")), adds=stats[:, 0], drops=stats[:, 1],
        expiry_evictions=stats[:, 2], capacity_evictions=stats[:, 3],
        occupancy=torch.stack(col("occupancy")), load_factor=load,
    )
    if "routing" in per_chunk[0]:
        routing = torch.stack(col("routing"))  # [C, 4]
        series.update(router_consults=routing[:, 0], directory_fetches=routing[:, 1],
                      mis_routes=routing[:, 2], stale_consults=routing[:, 3],
                      stale_age_hist=torch.stack(col("stale_age_hist")))
    if "fault" in per_chunk[0]:
        fault, fracs = torch.stack(col("fault")), torch.stack(col("fracs"))
        series.update(unavailable_reads=fault[:, 0], unavailable_writes=fault[:, 1],
                      failovers=fault[:, 2], repair_moves=fault[:, 3],
                      unreachable_frac=fracs[:, 0], wiped_frac=fracs[:, 1])
    for name in ("attr_hist", "attr_sum", "flight_meta", "flight_vals"):
        if name in per_chunk[0]:
            series[name] = torch.stack(col(name))
    return series


def _chunk_sums(x: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """``[..., R]`` summed over chunks of ``chunk_size`` along the last axis
    (the last chunk may be short), in f64 rounded once to f32: ``[..., C]``."""
    r = x.shape[-1]
    full = r // chunk_size * chunk_size
    sums = [x[..., :full].reshape(*x.shape[:-1], -1, chunk_size).sum(dim=-1, dtype=torch.float64)]
    if full < r:
        sums.append(x[..., full:].sum(dim=-1, keepdim=True, dtype=torch.float64))
    return torch.cat(sums, dim=-1).float()


def _static_attribution(hosts, keys, nodes, is_read, rtt, read_mode, scalars, extra, acfg, fpos,
                        chunk_size: int, n: int) -> dict:
    """The static path's attribution and flight leaves over the whole trace
    (still on the device): the components in slabs of ``SLAB_ROWS``
    requests against the frozen map (contention the only surcharge: routing
    and faults always take the chunk loop), then the per-chunk component
    histograms and sums, and every chunk's flight records at once."""
    r = keys.shape[0]
    comps = torch.empty((NUM_COMPONENTS, r), dtype=torch.float32, device=keys.device)
    for lo in range(0, r, SLAB_ROWS):
        hi = min(lo + SLAB_ROWS, r)
        comps[:, lo:hi] = chunk_components_ref(
            hosts, keys[lo:hi], nodes[lo:hi], is_read[lo:hi], rtt, read_mode=read_mode,
            contention_ms=None if extra is None else extra[lo:hi], **scalars,
        )
    out = {}
    if acfg is not None:
        group = (nodes * 2 + is_read.to(torch.int32)).to(torch.int32)
        weight = torch.ones(r, dtype=torch.float32, device=keys.device)
        out["attr_hist"] = telemetry_mod.attribution_trace_hist(comps, group, weight, acfg, n,
                                                                rows_per_chunk=chunk_size)
        out["attr_sum"] = _chunk_sums(comps, chunk_size).T
        del group, weight
    if fpos is not None:
        chunk0 = torch.arange(fpos.shape[0], dtype=torch.int64, device=keys.device)[:, None]
        out["flight_meta"], out["flight_vals"] = _flight_sample(
            chunk0 * chunk_size + fpos, 0, keys, nodes, is_read, None, comps, None)
    return out


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


def _leaves(host: dict, loop: bool, num_chunks: int) -> TelemetryLeaves:
    """The run's leaves on the host. A tier that was off gets zero leaves,
    as the reference fills them: per chunk on its chunk loop, and on its
    static path the routing series only (the fault leaves keep their scalar
    default)."""
    zeros_c = np.zeros(num_chunks)
    fill = dict(
        router_consults=zeros_c, directory_fetches=zeros_c, mis_routes=zeros_c,
        stale_consults=zeros_c, stale_age_hist=np.zeros((num_chunks, STALE_AGE_BINS)),
    )
    if loop:
        fill.update(
            unavailable_reads=zeros_c, unavailable_writes=zeros_c, failovers=zeros_c,
            repair_moves=zeros_c, unreachable_frac=zeros_c, wiped_frac=zeros_c,
        )
    return TelemetryLeaves(**{**fill, **host})


def _reference_engine(
    trace: Trace, cluster: ClusterConfig, static, params: dict, daemon_interval: int,
    tcfg: TelemetryConfig | None,
) -> tuple[SimResult, TelemetryLeaves | None, np.ndarray | None, np.ndarray | None]:
    """The per-chunk loop of plain PyTorch on the trace's device, the policy
    through its plain ``decide``, float64 accumulators on the host. Returns
    ``(result, telemetry leaves | None, per-request latencies | None,
    per-request components [NUM_COMPONENTS, R] | None)``; the flight
    totals and component sums are f64 sums of the f32 components.

    With routing on and faults off the published view is the snapshot of
    ``publish_lag_chunks`` chunks ago, kept in a history of chunk-start
    snapshots; with faults on it comes from the publish ring, which a down
    directory home freezes."""
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
    routing = _routing_kwargs(cluster, k)
    fault = _fault_kwargs(cluster, num_chunks)
    if routing is not None:
        lag = routing["publish_lag_chunks"]
        rstate = init_router_state(
            store.hosts, num_routers=routing["num_routers"],
            cache_entries=routing["cache_entries"], publish_lag_chunks=lag,
            active=static.is_active, force_ring=fault is not None,
        )
        history = deque(maxlen=lag + 1)  # chunk-start (hosts, version) snapshots
    if fault is not None:
        wiped = torch.zeros(k, dtype=torch.bool, device=dev)
    acfg = None if tcfg is None else tcfg.attribution
    fcfg = None if tcfg is None else tcfg.flight
    if fcfg is not None:
        fpos = _flight_positions(fcfg, num_chunks, daemon_interval, dev)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.to(torch.float64).cpu().numpy()

    busy = np.zeros(n)
    hits = reads = lat_sum = 0.0
    moves = np.zeros(4)  # adds, drops, expiry evictions, capacity evictions
    tiers = np.zeros(8)  # as _simulate's
    peak = host(_node_occupancy(store.hosts, obj))
    per_chunk, raw, raw_comps = [], [], []
    for c in range(num_chunks):
        lo, hi = c * daemon_interval, min((c + 1) * daemon_interval, r)
        ck, cn, cr = keys[lo:hi], nodes[lo:hi], is_read[lo:hi]
        cv = torch.ones_like(cr)
        row = {}
        served, hosts_eff, f_extra = cv, store.hosts, None
        avail_c = detour = fetch = None
        if fault is not None:
            avail_c = torch.from_numpy(fault["avail"][c]).to(dev)
            post = store.hosts & ~torch.from_numpy(fault["crash"][c]).to(dev)[None, :]
            wiped = wiped | (store.hosts.any(dim=-1) & ~post.any(dim=-1))
            store = store._replace(hosts=post)
            f_extra, unavail, failover = fault_extra_ms_ref(
                store.hosts, ck, cn, cr, cv, avail_c, rtt, read_mode=static.read_mode,
                master=sc["master"], xfer_write_ms=sc["xfer_write_ms"], wiped=wiped,
            )
            served = cv & ~unavail
            hosts_eff = store.hosts & avail_c[None, :]
        lat, read_hits = chunk_latency_ref(hosts_eff, ck, cn, cr, rtt, read_mode=static.read_mode,
                                           **sc)
        route = None
        if routing is not None:
            if not static.is_active:
                pub_hosts, pub_ver = store.hosts, torch.zeros(k, dtype=torch.int32, device=dev)
            elif fault is not None:
                pub_hosts, pub_ver = published_view(rstate, store.hosts, c, publish_lag_chunks=lag)
            else:
                history.append((store.hosts, rstate.ver))
                pub_hosts, pub_ver = history[0]  # the snapshot of chunk max(c - lag, 0)
            rb = router_of(cn, routing["num_routers"])
            ent_cached, fresh, age = consult_probe(rstate, rb, ck)
            detour, fetch, consult, fetched, stale, mis = routing_extra_split_ref(
                hosts_eff, pub_hosts, ent_cached, fresh, ck, cn, cr, served, rtt,
                read_mode=static.read_mode, home_node=routing["home_node"],
            )
            route = detour + fetch
        rho = extra = None
        if contention is not None:
            extra, rho = contention_extra_ms_ref(hosts_eff, ck, cn, cr, served, rtt, obj,
                                                 **contention)
        comps = None
        if acfg is not None or fcfg is not None:
            comps = chunk_components_ref(
                hosts_eff, ck, cn, cr, rtt, read_mode=static.read_mode, contention_ms=extra,
                routing_detour_ms=detour, directory_fetch_ms=fetch, avail=avail_c, **sc,
            )
            if fault is not None:
                comps = torch.where(served[None, :], comps,
                                    torch.zeros((), dtype=torch.float32, device=dev))
        if route is not None:
            extra = route if extra is None else route + extra
        if f_extra is not None:
            extra = f_extra if extra is None else f_extra + extra
        if extra is not None:
            lat = lat + extra
        if fault is not None:
            lat = torch.where(served, lat, torch.zeros((), dtype=torch.float32, device=dev))
        busy += host(torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
            0, cn.long(), lat.to(torch.float64)))
        c_lat = float(lat.sum(dtype=torch.float64))
        c_hits, c_reads = float((read_hits & served).sum()), float((cr & served).sum())
        lat_sum += c_lat
        hits += c_hits
        reads += c_reads
        if fault is not None:
            unreach = (store.hosts.any(dim=-1) & ~hosts_eff.any(dim=-1)) | wiped
            row["fault"] = [float((unavail & cr).sum()), float((unavail & ~cr).sum()),
                            float(failover.sum()), 0.0]
            row["fracs"] = [float(unreach.sum()) / k, float(wiped.sum()) / k]
        occ = host(_node_occupancy(store.hosts, obj))
        peak = np.maximum(peak, occ)
        if routing is not None:
            row["routing"] = [float(consult.sum()), float(fetched.sum()), float(mis.sum()),
                              float(stale.sum())]
            row["stale_age_hist"] = host(stale_age_fold(age, stale))
            rstate = router_cache_update(rstate, rb, ck, consult, pub_ver,
                                         cache_entries=routing["cache_entries"],
                                         decay=routing["decay"])
        c_moves = np.zeros(4)
        if static.is_active:
            store = record_accesses(store, ck, cn, now=c,
                                    valid=None if fault is None else avail_c[cn.long()])
            prev_hosts = store.hosts
            if c % static.period == 0:
                step_ctx = ctx if fault is None else ctx._replace(avail=avail_c)
                plan, pstate, store = policy_sweep(static, pstate, store, c, step_ctx, fused=False)
                evicted = plan.capacity_evicted
                c_moves = np.array([
                    float(plan.to_add.sum()), float(plan.to_drop.sum()),
                    float((plan.to_drop & plan.expired[:, None]).sum()),
                    0.0 if evicted is None else float(evicted.sum()),
                ])
                moves += c_moves
            if fault is not None:
                added = store.hosts & ~prev_hosts
                lost_live = prev_hosts.any(dim=-1) & ~(prev_hosts & avail_c[None, :]).any(dim=-1)
                row["fault"][3] = float((added & (wiped | lost_live)[:, None]).sum())
                wiped = wiped & ~(store.hosts & avail_c[None, :]).any(dim=-1)
            if routing is not None:
                changed = publish_mask(prev_hosts, store.hosts)
                if fault is not None:
                    rstate = publish_commit(
                        rstate, changed, store.hosts, c, publish_lag_chunks=lag,
                        daemon_up=bool(fault["avail"][c, routing["home_node"]]),
                    )
                else:
                    rstate = rstate._replace(ver=rstate.ver + changed.to(torch.int32))
        tiers += np.concatenate([row.get("routing", np.zeros(4)), row.get("fault", np.zeros(4))])
        if tcfg is not None:
            group = cn.long() * 2 + cr.long()
            hist = latency_histogram_ref(
                lat, group, served.to(torch.float32), num_groups=2 * n, num_bins=tcfg.num_bins,
                lo=tcfg.lo_ms, hi=tcfg.hi_ms)
            row.update(
                hist=host(hist), hits=c_hits, reads=c_reads, lat_sum=c_lat,
                count=float(hi - lo) if fault is None else float(served.sum()),
                adds=c_moves[0], drops=c_moves[1], expiry_evictions=c_moves[2],
                capacity_evictions=c_moves[3], occupancy=occ,
                load_factor=np.zeros(n) if rho is None else host(rho),
            )
            if acfg is not None:
                row["attr_hist"] = host(telemetry_mod.attribution_chunk_hist(
                    comps, group.to(torch.int32), served.to(torch.float32), acfg, n,
                    histogram=latency_histogram_ref))
                row["attr_sum"] = host(comps).sum(axis=1)
            if fcfg is not None:  # f64 components: the totals are f64 sums
                meta, vals = _flight_sample(fpos[c], lo, ck, cn, cr, served, comps.double(),
                                            None if routing is None else rb)
                row["flight_meta"], row["flight_vals"] = host(meta), host(vals)
            per_chunk.append(row)
            raw.append(host(lat))
            if comps is not None:
                raw_comps.append(host(comps))

    served_r = r if fault is None else max(r - tiers[4] - tiers[5], 1.0)
    result = SimResult(
        r / (float(busy.max()) / 1000.0), hits / max(reads, 1.0), lat_sum / served_r, busy,
        *(float(x) for x in moves), peak, *(float(x) for x in tiers),
    )
    if tcfg is None:
        return result, None, None, None
    stacked = {name: np.stack([np.asarray(row[name]) for row in per_chunk])
               for name in per_chunk[0]}
    for name, cols in (("routing", ("router_consults", "directory_fetches", "mis_routes",
                                    "stale_consults")),
                       ("fault", ("unavailable_reads", "unavailable_writes", "failovers",
                                  "repair_moves")),
                       ("fracs", ("unreachable_frac", "wiped_frac"))):
        if name in stacked:
            stacked.update(zip(cols, stacked.pop(name).T))
    raw_c = np.concatenate(raw_comps, axis=1) if raw_comps else None
    return result, _leaves(stacked, True, num_chunks), np.concatenate(raw), raw_c


def run_scenario_reference(
    workload: WorkloadConfig,
    cluster: ClusterConfig,
    policy=None,
    seed: int = 0,
    daemon_interval: int = 1000,
    *,
    device: str | torch.device | None = None,
    trace: Trace | None = None,
    telemetry: TelemetryConfig | None = None,
) -> SimResult | tuple[SimResult, SimTrace]:
    """The slow-path oracle of :func:`run_scenario`: one chunk at a time in
    plain PyTorch on ``device`` (no kernel, on the card too), the policy
    stepped on the host, float64 accumulators, on ``trace`` or else
    ``generate_trace(workload, seed)``. The same semantics, so the results
    agree with ``run_scenario``'s to the f32 engine's rounding. With
    ``telemetry`` it returns ``(SimResult, SimTrace)`` and the trace carries
    ``raw_latency_ms``, every request's latency, and with attribution or the
    flight recorder ``raw_components``, every request's components."""
    _check_slice(workload, cluster, caller="run_scenario_reference")
    tcfg = normalize_telemetry(telemetry)
    static, params = _prepare(workload, policy, daemon_interval, "run_scenario_reference")
    dev = resolve_device(device)
    if trace is None:
        trace = generate_trace(workload, seed, device=dev)
    result, leaves, raw, raw_c = _reference_engine(trace.to(dev), cluster, static, params,
                                                   daemon_interval, tcfg)
    if tcfg is None:
        return result
    return result, build_trace(leaves, tcfg, raw_latency_ms=raw, raw_components=raw_c)


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
    """Per-seed leaves stacked on a leading seed axis (``None`` leaves, a
    sub-config off, stay ``None``)."""
    return TelemetryLeaves(*(None if field[0] is None else np.stack([np.asarray(x) for x in field])
                             for field in zip(*leaves)))


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
        _reject_scenario("run_experiment", pol)
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
