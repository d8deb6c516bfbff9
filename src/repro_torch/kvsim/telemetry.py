"""Telemetry: grouped latency histograms, per-chunk convergence series,
cost attribution and the flight recorder (counterpart of
``src/repro/kvsim/telemetry.py``).

Per chunk the engine folds every request's latency into a ``[2N, B]``
log-bin histogram whose group id is ``node * 2 + is_read``; the global,
per-node and read/write views are row-sums of it, so histograms merge
across chunks and runs by summation. The fold runs on the device: inside
the ``chunk_replay`` kernel on the chunk loop, and in one
``latency_histogram`` launch over the whole trace on the static path
(:func:`trace_histogram`). With failure injection on, only served requests
are binned. The per-chunk series (hit rate, mean and P99 latency, moves,
occupancy, load factor, the routing tier's consults and staleness ages,
the availability and blast-radius counters) come back to the host once, at
the end of the run, and :func:`build_trace` turns them into a
:class:`SimTrace`.

Cost attribution (``AttributionConfig``) cuts every request's latency
along the eight rows of ``COMPONENTS`` (``chunk_components_ref``) and folds
per-component ``[2N, Ba]`` histograms, each weighted by ``component > 0``
(a row counts the requests that paid it), and per-chunk component sums.
The fold goes through ``latency_histogram`` with the component as a 0/1
weight (:func:`attribution_chunk_hist`, :func:`attribution_trace_hist`), so
on the card it is the CUDA kernel at the attribution's own bin rule. The
flight recorder (``FlightRecorderConfig``) keeps ``samples_per_chunk``
sampled requests a chunk: an integer plane (:data:`FLIGHT_META_FIELDS`)
and a float plane (the total, then the eight components).

Quantiles are interpolated from the log-spaced histogram in numpy on the
host; bins have constant relative width ``(hi/lo)**(1/(B-2))``, so an
interpolated quantile is within one bin width of the exact order
statistic.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.chunk_replay.ref import COMPONENTS, NUM_COMPONENTS
from repro_torch.kernels.latency_histogram.ops import latency_histogram
from repro_torch.kernels.latency_histogram.ref import bin_edges
from repro_torch.spmd import all_sum

__all__ = [
    "AttributionConfig",
    "FlightRecorderConfig",
    "TelemetryConfig",
    "TelemetryLeaves",
    "LEAF_KINDS",
    "SimTrace",
    "STALE_AGE_BINS",
    "chunk_histogram",
    "trace_histogram",
    "attribution_chunk_hist",
    "attribution_trace_hist",
    "merge_leaves",
    "psum_leaves",
    "build_trace",
    "leaves_quantile",
    "histogram_quantile",
    "histogram_quantile_rows",
    "quantile_summary",
    "normalize_telemetry",
    "QUANTILE_LABELS",
    "COMPONENTS",
    "NUM_COMPONENTS",
    "FLIGHT_SAMPLING_MODES",
    "FLIGHT_META_FIELDS",
]

TELEMETRY_BACKENDS = ("jax", "pallas")
FLIGHT_SAMPLING_MODES = ("stride", "reservoir")

# Columns of the flight recorder's integer plane: ``flags`` is bit 0 =
# is_read, bit 1 = valid (clear for an unsampled or unserved slot).
FLIGHT_META_FIELDS = ("pos", "key", "node", "router", "flags")
STALE_AGE_BINS = 16  # width of the routing tier's (zero-filled) age histogram

# The canonical report quantiles: label -> q.
QUANTILE_LABELS = {"p50": 0.5, "p90": 0.9, "p95": 0.95, "p99": 0.99, "p999": 0.999}


class AttributionConfig(NamedTuple):
    """Cost-attribution knobs: per-component ``[2N, num_bins]`` histograms
    on their own log bins (the default floor of 0.01 ms sits two decades
    below the total's, as single legs are often sub-millisecond) and
    per-chunk component sums. Off (``None`` on the telemetry config) by
    default."""

    enabled: bool = True
    num_bins: int = 64
    lo_ms: float = 0.01
    hi_ms: float = 10_000.0

    def validate(self) -> None:
        if self.num_bins < 4:
            raise ValueError(f"attribution num_bins must be >= 4, got {self.num_bins}")
        if not (0.0 < self.lo_ms < self.hi_ms):
            raise ValueError(
                f"attribution needs 0 < lo_ms < hi_ms, got lo_ms={self.lo_ms} hi_ms={self.hi_ms}"
            )

    def edges(self) -> np.ndarray:
        """Host-side ``[num_bins + 1]`` bin edges: ``[0, lo, ..., hi, inf]``."""
        return bin_edges(self.lo_ms, self.hi_ms, self.num_bins)


class FlightRecorderConfig(NamedTuple):
    """Sampled per-request records: ``samples_per_chunk`` a chunk, at fixed
    equally spaced in-chunk offsets (``"stride"``) or at offsets drawn from
    ``fold_in(PRNGKey(0x9E37), chunk)`` (``"reservoir"``), the same in
    every engine. Export with ``kvsim.tracing``."""

    enabled: bool = True
    samples_per_chunk: int = 8
    mode: str = "stride"

    def validate(self) -> None:
        if self.samples_per_chunk < 1:
            raise ValueError(
                f"flight samples_per_chunk must be >= 1, got {self.samples_per_chunk}"
            )
        if self.mode not in FLIGHT_SAMPLING_MODES:
            raise ValueError(
                f"unknown flight sampling mode {self.mode!r}; expected one of "
                f"{FLIGHT_SAMPLING_MODES}"
            )


class TelemetryConfig(NamedTuple):
    """Histogram and trace collection knobs.

    Telemetry is off by default at the engine (``telemetry=None``); a
    config turns it on unless ``enabled=False``. ``num_bins`` counts the
    underflow (< ``lo_ms``) and overflow (>= ``hi_ms``) buckets; the
    ``num_bins - 2`` interior bins are log-spaced. ``backend`` is kept and
    validated so that a reference config carries across field by field,
    but it selects nothing: the device does, as in every ``ops.py`` (the
    CUDA kernels for tensors on the card, the plain versions on the CPU).
    ``attribution`` and ``flight`` turn on cost attribution and the flight
    recorder.
    """

    enabled: bool = True
    num_bins: int = 128
    lo_ms: float = 1.0
    hi_ms: float = 10_000.0
    backend: str = "jax"
    attribution: AttributionConfig | None = None
    flight: FlightRecorderConfig | None = None

    def validate(self) -> None:
        if self.num_bins < 4:
            raise ValueError(
                f"num_bins must be >= 4 (2 interior + under/overflow), got {self.num_bins}"
            )
        if not (0.0 < self.lo_ms < self.hi_ms):
            raise ValueError(f"need 0 < lo_ms < hi_ms, got lo_ms={self.lo_ms} hi_ms={self.hi_ms}")
        if self.backend not in TELEMETRY_BACKENDS:
            raise ValueError(
                f"unknown telemetry backend {self.backend!r}; expected one of {TELEMETRY_BACKENDS}"
            )

    def edges(self) -> np.ndarray:
        """Host-side ``[num_bins + 1]`` bin edges: ``[0, lo, ..., hi, inf]``."""
        return bin_edges(self.lo_ms, self.hi_ms, self.num_bins)


def normalize_telemetry(telemetry: TelemetryConfig | None) -> TelemetryConfig | None:
    """``None`` and ``enabled=False`` both mean no telemetry; an enabled
    config is validated. A disabled attribution or flight sub-config
    collapses to ``None`` (its off state), an enabled one is validated."""
    if telemetry is None or not telemetry.enabled:
        return None
    telemetry.validate()
    subs = {}
    for name in ("attribution", "flight"):
        sub = getattr(telemetry, name)
        if sub is not None and not sub.enabled:
            sub = None
        if sub is not None:
            sub.validate()
        subs[name] = sub
    return telemetry._replace(**subs)


class TelemetryLeaves(NamedTuple):
    """Raw per-chunk accumulators, chunk axis first, as numpy arrays after
    the run's one readback. Every field is a sum over requests except the
    point samples ``occupancy``, ``load_factor``, ``unreachable_frac`` and
    ``wiped_frac``. A tier that is off has zero leaves, as in the reference
    (the fault leaves a scalar ``0.0`` on the static whole-trace path); an
    attribution or flight leaf is ``None`` with its sub-config off."""

    hist: Any  # [C, 2N, B] grouped latency histogram per chunk
    hits: Any  # [C] read hits
    reads: Any  # [C] valid reads
    lat_sum: Any  # [C] summed latency (ms)
    count: Any  # [C] valid requests
    adds: Any  # [C] replicas created by the policy sweep
    drops: Any  # [C] replicas dropped (all causes)
    expiry_evictions: Any  # [C] drops caused by key expiry
    capacity_evictions: Any  # [C] held replicas evicted by a budget
    occupancy: Any  # [C, N] replica bytes on the chunk's frozen map
    load_factor: Any = 0.0  # [C, N] serving-node rho (zeros: contention off)
    router_consults: Any = 0.0  # [C] directory consults
    directory_fetches: Any = 0.0  # [C] cache misses
    mis_routes: Any = 0.0  # [C] consults detoured by a stale view
    stale_consults: Any = 0.0  # [C] consults of a stale entry
    stale_age_hist: Any = 0.0  # [C, STALE_AGE_BINS] version gaps of stale consults
    unavailable_reads: Any = 0.0  # [C] reads refused
    unavailable_writes: Any = 0.0  # [C] writes refused
    failovers: Any = 0.0  # [C] writes through a stand-in master
    repair_moves: Any = 0.0  # [C] re-seeded copies of keys with no live copy
    unreachable_frac: Any = 0.0  # [C] share of keys with no live replica
    wiped_frac: Any = 0.0  # [C] share of keys whose every replica a crash destroyed
    attr_hist: Any = None  # [C, NUM_COMPONENTS, 2N, Ba] component counts
    attr_sum: Any = None  # [C, NUM_COMPONENTS] summed ms
    flight_meta: Any = None  # [C, S, 5] int (FLIGHT_META_FIELDS)
    flight_vals: Any = None  # [C, S, 1 + NUM_COMPONENTS] total, then components


# How each leaf merges across a batch axis (seeds, policy rows): "sum"
# leaves add, "mean" point samples average, "records" keep row 0's samples
# (a merged trace carries seed 0's flight records).
LEAF_KINDS = {
    "hist": "sum",
    "hits": "sum",
    "reads": "sum",
    "lat_sum": "sum",
    "count": "sum",
    "adds": "sum",
    "drops": "sum",
    "expiry_evictions": "sum",
    "capacity_evictions": "sum",
    "occupancy": "mean",
    "load_factor": "mean",
    "router_consults": "sum",
    "directory_fetches": "sum",
    "mis_routes": "sum",
    "stale_consults": "sum",
    "stale_age_hist": "sum",
    "unavailable_reads": "sum",
    "unavailable_writes": "sum",
    "failovers": "sum",
    "repair_moves": "sum",
    "unreachable_frac": "mean",
    "wiped_frac": "mean",
    "attr_hist": "sum",
    "attr_sum": "sum",
    "flight_meta": "records",
    "flight_vals": "records",
}


def _hist_kwargs(cfg: TelemetryConfig, num_nodes: int) -> dict:
    return dict(num_groups=2 * num_nodes, num_bins=cfg.num_bins, lo=cfg.lo_ms, hi=cfg.hi_ms)


def chunk_histogram(
    lat: torch.Tensor,  # [R] f32 per-request latency (ms)
    group: torch.Tensor,  # [R] int32 group id = node * 2 + is_read
    weight: torch.Tensor,  # [R] f32, 0 masks a row
    cfg: TelemetryConfig,
    num_nodes: int,
) -> torch.Tensor:
    """One chunk's ``[2N, B]`` grouped histogram (the kernel on the card)."""
    return latency_histogram(lat, group, weight, **_hist_kwargs(cfg, num_nodes))


def trace_histogram(
    lat: torch.Tensor,  # [R] f32 whole-trace latencies, chunk-major
    group: torch.Tensor,  # [R] int32 group id = node * 2 + is_read
    weight: torch.Tensor,  # [R] f32, 0 masks a row
    cfg: TelemetryConfig,
    num_nodes: int,
    rows_per_chunk: int,
) -> torch.Tensor:
    """The whole trace's ``[C, 2N, B]`` per-chunk histograms in one pass
    (one kernel launch on the card); the last chunk may be short. Counts
    equal ``C`` separate :func:`chunk_histogram` calls."""
    return latency_histogram(
        lat, group, weight, rows_per_chunk=rows_per_chunk, **_hist_kwargs(cfg, num_nodes)
    )


def attribution_chunk_hist(
    comps: torch.Tensor,  # [NUM_COMPONENTS, B] f32 per-request components (masked)
    group: torch.Tensor,  # [B] int32 group id = node * 2 + is_read
    weight: torch.Tensor,  # [B] f32, 0 masks a row
    acfg: AttributionConfig,
    num_nodes: int,
    histogram=None,
) -> torch.Tensor:
    """One chunk's ``[NUM_COMPONENTS, 2N, Ba]`` per-component histograms,
    each row weighted by ``component > 0``, in one ``latency_histogram``
    call with ``NUM_COMPONENTS * 2N`` groups (group ``c * 2N + g``): a chunk
    is small, so the ``[NUM_COMPONENTS * B]`` group and weight vectors cost
    little, and the fold is one launch on the card. ``histogram`` replaces
    the wrapper (the reference engine passes the plain version)."""
    ncomp, b = comps.shape
    g = 2 * num_nodes
    offs = torch.arange(ncomp, dtype=torch.int32, device=comps.device)[:, None] * g
    hist = (histogram or latency_histogram)(
        comps.reshape(-1), (offs + group.to(torch.int32)[None, :]).reshape(-1),
        (weight.to(torch.float32)[None, :] * (comps > 0).to(torch.float32)).reshape(-1),
        num_groups=ncomp * g, num_bins=acfg.num_bins, lo=acfg.lo_ms, hi=acfg.hi_ms,
    )
    return hist.reshape(ncomp, g, acfg.num_bins)


def attribution_trace_hist(
    comps: torch.Tensor,  # [NUM_COMPONENTS, R] f32 whole-trace components (masked)
    group: torch.Tensor,  # [R] int32 group id = node * 2 + is_read
    weight: torch.Tensor,  # [R] f32, 0 masks a row
    acfg: AttributionConfig,
    num_nodes: int,
    rows_per_chunk: int,
) -> torch.Tensor:
    """The whole trace's ``[C, NUM_COMPONENTS, 2N, Ba]`` per-chunk
    attribution histograms: one per-chunk ``latency_histogram`` call a
    component (``NUM_COMPONENTS`` launches on the card), stacked. Not one
    call over ``NUM_COMPONENTS * 2N`` groups as a chunk takes: that needs
    ``[NUM_COMPONENTS * R]`` group and weight vectors, 6.4 GB beside the
    3.2 GB of components at 10**8 requests, where a component a call reads
    its row of ``comps`` in place, shares ``group`` and makes one ``[R]``
    weight (0.4 GB) at a time. Counts are integers: the same as ``C``
    :func:`attribution_chunk_hist` calls."""
    rows = []
    for comp in comps:
        w = weight.to(torch.float32) * (comp > 0).to(torch.float32)
        rows.append(latency_histogram(
            comp, group, w, num_groups=2 * num_nodes, num_bins=acfg.num_bins,
            lo=acfg.lo_ms, hi=acfg.hi_ms, rows_per_chunk=rows_per_chunk,
        ))
        del w
    return torch.stack(rows, dim=1)


def merge_leaves(leaves: TelemetryLeaves, axis: int = 0) -> TelemetryLeaves:
    """Merge a batch axis away, leaf by leaf per :data:`LEAF_KINDS`:
    "sum" leaves add, "mean" point samples average, "records" keep batch
    row 0; ``None`` leaves (a sub-config off) pass through."""
    n = np.asarray(leaves.occupancy).shape[axis]
    merged = {}
    for name, kind in LEAF_KINDS.items():
        leaf = getattr(leaves, name)
        if leaf is None:
            merged[name] = None
            continue
        a = np.asarray(leaf, dtype=np.float64)
        if a.ndim == 0:
            merged[name] = a
        elif kind == "sum":
            merged[name] = a.sum(axis=axis)
        elif kind == "mean":
            merged[name] = a.sum(axis=axis) / n
        else:
            merged[name] = np.take(a, 0, axis=axis)
    return TelemetryLeaves(**merged)


def psum_leaves(series: dict, group) -> dict:
    """A key-sharded rank's per-chunk series (device tensors by leaf name)
    folded over the ranks of ``group``, leaf by leaf per
    :data:`LEAF_KINDS`, as the reference's ``psum_leaves`` folds them:
    "sum" leaves add (integer counts exactly); "records" leaves add too,
    since each flight slot is filled by the one rank that owns its request
    and zero elsewhere; "mean" point samples were folded where they were
    sampled and pass through. One ``all_reduce`` a dtype. ``group=None``
    returns ``series``."""
    if group is None:
        return series
    out = dict(series)
    by_dtype: dict = {}
    for name, t in series.items():
        if LEAF_KINDS[name] != "mean":
            by_dtype.setdefault(t.dtype, []).append(name)
    for names in by_dtype.values():
        flat = all_sum(torch.cat([series[name].reshape(-1) for name in names]), group)
        for name, part in zip(names, flat.split([series[name].numel() for name in names])):
            out[name] = part.view(series[name].shape)
    return out


# ---------------------------------------------------------------------------
# Quantile interpolation on log-spaced histograms (numpy, on the host).
# ---------------------------------------------------------------------------


def histogram_quantile(hist: np.ndarray, edges: np.ndarray, q: float) -> float:
    """Interpolated quantile from binned counts: within the target bucket
    the mass is spread geometrically (uniform in log-latency), so the result
    is within one bin width of the exact order statistic. The unbounded
    under- and overflow buckets clamp to their finite edge."""
    hist = np.asarray(hist, dtype=np.float64)
    return float(histogram_quantile_rows(hist[None, :], edges, q)[0])


def histogram_quantile_rows(hists: np.ndarray, edges: np.ndarray, q: float) -> np.ndarray:
    """:func:`histogram_quantile` over a ``[C, B]`` stack of histograms
    (the per-chunk P99 series); ``nan`` for an empty row."""
    hists = np.asarray(hists, dtype=np.float64)
    total = hists.sum(axis=1)
    safe_total = np.maximum(total, 1e-300)
    target = q * safe_total
    cum = np.cumsum(hists, axis=1)
    b = np.minimum((cum < target[:, None]).sum(axis=1), hists.shape[1] - 1)
    rows = np.arange(hists.shape[0])
    prev = np.where(b > 0, cum[rows, np.maximum(b - 1, 0)], 0.0)
    frac = np.clip((target - prev) / np.maximum(hists[rows, b], 1e-12), 0.0, 1.0)
    lo_e = edges[b]
    hi_e = edges[b + 1]
    overflow = ~np.isfinite(hi_e)
    hi_safe = np.where(overflow, 1.0, hi_e)  # masked out below
    lo_safe = np.maximum(lo_e, 1e-300)
    interior = np.where(
        lo_e <= 0.0,
        hi_safe * frac,  # degenerate [0, lo) bucket: linear
        lo_e * (hi_safe / lo_safe) ** frac,
    )
    out = np.where(
        b == 0,
        edges[1],  # underflow bucket: clamp to lo
        np.where(overflow, lo_e, interior),  # overflow bucket: clamp to hi
    )
    return np.where(total > 0, out, np.nan)


def quantile_summary(hist: np.ndarray, edges: np.ndarray) -> dict:
    """The canonical P50/P90/P95/P99/P99.9 block."""
    return {label: histogram_quantile(hist, edges, q) for label, q in QUANTILE_LABELS.items()}


def leaves_quantile(leaves: TelemetryLeaves, cfg: TelemetryConfig, q: float) -> float:
    """Global quantile straight from raw leaves, no :class:`SimTrace` built."""
    hist = np.asarray(leaves.hist, dtype=np.float64)  # [C, 2N, B]
    return histogram_quantile(hist.sum(axis=(0, 1)), cfg.edges(), q)


# ---------------------------------------------------------------------------
# SimTrace: the user-facing view.
# ---------------------------------------------------------------------------


class SimTrace(NamedTuple):
    """Telemetry of one run (or a merged aggregate): the grouped latency
    histogram and the per-chunk convergence series.

    ``hist_group`` rows follow ``g = node * 2 + is_read`` (even rows writes,
    odd rows reads); ``hist``, ``hist_read``, ``hist_write`` and
    ``hist_node`` are row-sums. ``load_factor`` is the per-chunk
    serving-node rho (zeros with contention off). The routing and
    failure-injection series are zero with their tier off;
    ``effective_hit_rate`` counts unavailable reads as misses.
    ``raw_latency_ms`` and ``raw_components`` are filled by
    ``run_scenario_reference`` only. The attribution and flight fields are
    ``None`` with their sub-config off.
    """

    edges: np.ndarray  # [B+1] bin edges (ms): [0, lo, ..., hi, inf]
    hist_group: np.ndarray  # [2N, B] whole-run grouped histogram
    chunk_hist: np.ndarray  # [C, B] global histogram per chunk
    hit_rate: np.ndarray  # [C] per-chunk read hit rate
    mean_latency_ms: np.ndarray  # [C]
    p99_latency_ms: np.ndarray  # [C] interpolated per-chunk P99
    moves: np.ndarray  # [C] replicas created per chunk
    drops: np.ndarray  # [C] replicas dropped per chunk
    evictions: np.ndarray  # [C] expiry evictions per chunk
    capacity_evictions: np.ndarray  # [C]
    occupancy_bytes: np.ndarray  # [C, N] frozen-map replica bytes
    requests: np.ndarray  # [C] valid requests per chunk
    raw_latency_ms: np.ndarray | None = None
    load_factor: np.ndarray | None = None  # [C, N]
    router_consults: np.ndarray | None = None
    directory_fetches: np.ndarray | None = None
    mis_routes: np.ndarray | None = None
    stale_consults: np.ndarray | None = None
    stale_age_hist: np.ndarray | None = None
    unavailable_reads: np.ndarray | None = None
    unavailable_writes: np.ndarray | None = None
    failovers: np.ndarray | None = None
    repair_moves: np.ndarray | None = None
    unreachable_frac: np.ndarray | None = None
    wiped_frac: np.ndarray | None = None
    effective_hit_rate: np.ndarray | None = None
    attr_edges: np.ndarray | None = None  # [Ba+1] component bin edges (ms)
    attr_hist_group: np.ndarray | None = None  # [NUM_COMPONENTS, 2N, Ba]
    attr_chunk_sum_ms: np.ndarray | None = None  # [C, NUM_COMPONENTS]
    attr_chunk_mean_ms: np.ndarray | None = None  # [C, NUM_COMPONENTS] a request
    flight_meta: np.ndarray | None = None  # [C, S, 5] (FLIGHT_META_FIELDS)
    flight_vals: np.ndarray | None = None  # [C, S, 1 + NUM_COMPONENTS]
    raw_components: np.ndarray | None = None  # [NUM_COMPONENTS, R] f64, reference engine

    # -- histogram views (row-sums of hist_group) ---------------------------

    @property
    def num_nodes(self) -> int:
        return self.hist_group.shape[0] // 2

    @property
    def hist(self) -> np.ndarray:
        """Global ``[B]`` latency histogram."""
        return self.hist_group.sum(axis=0)

    @property
    def hist_read(self) -> np.ndarray:
        return self.hist_group[1::2].sum(axis=0)

    @property
    def hist_write(self) -> np.ndarray:
        return self.hist_group[0::2].sum(axis=0)

    @property
    def hist_node(self) -> np.ndarray:
        """``[N, B]`` per-requesting-node histogram (reads + writes)."""
        b = self.hist_group.shape[1]
        return self.hist_group.reshape(self.num_nodes, 2, b).sum(axis=1)

    @property
    def relative_bin_width(self) -> float:
        """One interior bin's relative width: the quantile error bound."""
        return float(self.edges[2] / self.edges[1]) - 1.0

    # -- quantiles ----------------------------------------------------------

    def _select(self, split) -> np.ndarray:
        if isinstance(split, (int, np.integer)):
            return self.hist_node[int(split)]
        return {"all": self.hist, "read": self.hist_read, "write": self.hist_write}[split]

    def quantile(self, q: float, split="all") -> float:
        """Interpolated latency quantile; ``split`` is ``"all"``, ``"read"``,
        ``"write"`` or a node index."""
        return histogram_quantile(self._select(split), self.edges, q)

    def quantiles(self, qs, split="all") -> list[float]:
        hist = self._select(split)
        return [histogram_quantile(hist, self.edges, q) for q in qs]

    def tail_summary(self, split="all") -> dict:
        """P50/P90/P95/P99/P99.9 as a dict."""
        return quantile_summary(self._select(split), self.edges)

    # -- cost attribution and the flight recorder ---------------------------

    def _attr_rows(self, component) -> np.ndarray:
        if self.attr_hist_group is None:
            raise ValueError("attribution requires TelemetryConfig(attribution=AttributionConfig())")
        i = component if isinstance(component, (int, np.integer)) else COMPONENTS.index(component)
        return self.attr_hist_group[int(i)]  # [2N, Ba]

    def component_hist(self, component, split="all") -> np.ndarray:
        """One component's ``[Ba]`` histogram (by name or index); ``split``
        as in :meth:`quantile`."""
        rows = self._attr_rows(component)
        if isinstance(split, (int, np.integer)):
            return rows[int(split) * 2:int(split) * 2 + 2].sum(axis=0)
        return {"all": rows.sum(axis=0), "read": rows[1::2].sum(axis=0),
                "write": rows[0::2].sum(axis=0)}[split]

    def component_quantile(self, component, q: float, split="all") -> float:
        """Interpolated quantile of one component over the requests that
        paid it."""
        return histogram_quantile(self.component_hist(component, split), self.attr_edges, q)

    @property
    def attribution(self) -> dict:
        """For each :data:`COMPONENTS` name: ``count`` (requests that paid
        it), ``mean_ms`` (over all counted requests, so the means add up to
        the run's mean latency), ``share`` of the total, and P50–P99.9 over
        the paying requests."""
        if self.attr_hist_group is None:
            raise ValueError("attribution requires TelemetryConfig(attribution=AttributionConfig())")
        total_requests = float(self.requests.sum())
        comp_sums = self.attr_chunk_sum_ms.sum(axis=0)
        total_ms = float(comp_sums.sum())
        out = {}
        for i, name in enumerate(COMPONENTS):
            hist = self.attr_hist_group[i].sum(axis=0)
            out[name] = {
                "count": float(hist.sum()),
                "mean_ms": float(comp_sums[i]) / max(total_requests, 1.0),
                "share": float(comp_sums[i]) / max(total_ms, 1e-300),
                **{label: histogram_quantile(hist, self.attr_edges, q)
                   for label, q in QUANTILE_LABELS.items()},
            }
        return out

    def flight_records(self) -> list[dict]:
        """The flight recorder's valid samples as dicts, ordered by trace
        position: the :data:`FLIGHT_META_FIELDS` integers (``router`` -1
        with no routing tier), ``is_read``, ``chunk``, ``total_ms`` and the
        per-component ``components``."""
        if self.flight_meta is None:
            raise ValueError("flight_records requires TelemetryConfig(flight=FlightRecorderConfig())")
        meta = np.asarray(self.flight_meta, np.int64)
        vals = np.asarray(self.flight_vals, np.float64)
        records = []
        for c in range(meta.shape[0]):
            for s in range(meta.shape[1]):
                pos, key, node, router, flags = meta[c, s]
                if not (flags >> 1) & 1:
                    continue
                records.append({
                    "pos": int(pos), "chunk": int(c), "key": int(key), "node": int(node),
                    "router": int(router), "is_read": bool(flags & 1),
                    "total_ms": float(vals[c, s, 0]),
                    "components": {name: float(vals[c, s, 1 + i])
                                   for i, name in enumerate(COMPONENTS)},
                })
        records.sort(key=lambda r: r["pos"])
        return records

    # -- routing tier and availability --------------------------------------

    @property
    def mis_route_rate(self) -> np.ndarray:
        """``[C]`` share of each chunk's directory consults that a stale
        ownership view detoured (0 where nothing consulted)."""
        return self.mis_routes / np.maximum(self.router_consults, 1.0)

    @property
    def availability(self) -> np.ndarray:
        """``[C]`` share of each chunk's attempted requests that were served
        (1.0 where nothing was attempted, and everywhere with faults off)."""
        unav = np.asarray(self.unavailable_reads, np.float64) + np.asarray(
            self.unavailable_writes, np.float64)
        attempted = self.requests + unav
        return np.where(attempted > 0, self.requests / np.maximum(attempted, 1.0), 1.0)

    def recovery_chunks(self, outage_start: int, target_frac: float = 0.95) -> int:
        """Chunks from ``outage_start`` until the effective hit rate first
        recovers to ``target_frac`` of its pre-outage median (the median,
        so that an adaptive policy's cold start does not drag the baseline
        down); -1 if the trace ends first."""
        eff = self.effective_hit_rate
        baseline = float(np.median(eff[:outage_start])) if outage_start > 0 else 1.0
        ok = eff[outage_start:] >= target_frac * baseline
        if not ok.any():
            return -1
        return int(np.argmax(ok))

    # -- convergence / oscillation ------------------------------------------

    def convergence_chunk(self, eps: float = 0.01) -> int:
        """First chunk whose hit rate is within ``eps`` of the final chunk's
        (which trivially qualifies)."""
        terminal = self.hit_rate[-1]
        within = np.abs(self.hit_rate - terminal) <= eps
        return int(np.argmax(within))

    def post_convergence_moves(self, eps: float = 0.01) -> float:
        """Replica moves committed after convergence: an oscillation index
        (a stable policy goes quiet once placement has converged)."""
        return float(self.moves[self.convergence_chunk(eps):].sum())


def build_trace(
    leaves: TelemetryLeaves, cfg: TelemetryConfig, raw_latency_ms: np.ndarray | None = None,
    raw_components: np.ndarray | None = None,
) -> SimTrace:
    """A :class:`SimTrace` from chunk-leading leaves (one run's, or a
    merged aggregate from :func:`merge_leaves`)."""
    edges = cfg.edges()
    f64 = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
    hist_c = f64(leaves.hist)  # [C, 2N, B]
    chunk_hist = hist_c.sum(axis=1)  # [C, B]
    reads = f64(leaves.reads)
    count = f64(leaves.count)
    hits = f64(leaves.hits)
    attr = {}
    if cfg.attribution is not None and leaves.attr_hist is not None:
        attr_sum = f64(leaves.attr_sum)  # [C, NUM_COMPONENTS]
        attr.update(attr_edges=cfg.attribution.edges(),
                    attr_hist_group=f64(leaves.attr_hist).sum(axis=0),
                    attr_chunk_sum_ms=attr_sum,
                    attr_chunk_mean_ms=attr_sum / np.maximum(count, 1.0)[:, None])
    if cfg.flight is not None and leaves.flight_meta is not None:
        attr.update(flight_meta=np.asarray(leaves.flight_meta, np.int64),
                    flight_vals=f64(leaves.flight_vals))
    return SimTrace(
        **attr,
        raw_components=raw_components,
        edges=edges,
        hist_group=hist_c.sum(axis=0),
        chunk_hist=chunk_hist,
        hit_rate=hits / np.maximum(reads, 1.0),
        mean_latency_ms=f64(leaves.lat_sum) / np.maximum(count, 1.0),
        p99_latency_ms=histogram_quantile_rows(chunk_hist, edges, 0.99),
        moves=f64(leaves.adds),
        drops=f64(leaves.drops),
        evictions=f64(leaves.expiry_evictions),
        capacity_evictions=f64(leaves.capacity_evictions),
        occupancy_bytes=f64(leaves.occupancy),
        requests=count,
        raw_latency_ms=raw_latency_ms,
        load_factor=f64(leaves.load_factor),
        router_consults=f64(leaves.router_consults),
        directory_fetches=f64(leaves.directory_fetches),
        mis_routes=f64(leaves.mis_routes),
        stale_consults=f64(leaves.stale_consults),
        stale_age_hist=f64(leaves.stale_age_hist),
        unavailable_reads=f64(leaves.unavailable_reads),
        unavailable_writes=f64(leaves.unavailable_writes),
        failovers=f64(leaves.failovers),
        repair_moves=f64(leaves.repair_moves),
        unreachable_frac=f64(leaves.unreachable_frac),
        wiped_frac=f64(leaves.wiped_frac),
        effective_hit_rate=hits / np.maximum(reads + f64(leaves.unavailable_reads), 1.0),
    )
