"""Telemetry: grouped latency histograms and per-chunk convergence series
(counterpart of ``src/repro/kvsim/telemetry.py``, without cost attribution
and the flight recorder, which come with a later slice).

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

Quantiles are interpolated from the log-spaced histogram in numpy on the
host; bins have constant relative width ``(hi/lo)**(1/(B-2))``, so an
interpolated quantile is within one bin width of the exact order
statistic.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.latency_histogram.ops import latency_histogram
from repro_torch.kernels.latency_histogram.ref import bin_edges

__all__ = [
    "TelemetryConfig",
    "TelemetryLeaves",
    "LEAF_KINDS",
    "SimTrace",
    "STALE_AGE_BINS",
    "chunk_histogram",
    "trace_histogram",
    "merge_leaves",
    "build_trace",
    "leaves_quantile",
    "histogram_quantile",
    "histogram_quantile_rows",
    "quantile_summary",
    "normalize_telemetry",
    "QUANTILE_LABELS",
]

TELEMETRY_BACKENDS = ("jax", "pallas")
STALE_AGE_BINS = 16  # width of the routing tier's (zero-filled) age histogram

# The canonical report quantiles: label -> q.
QUANTILE_LABELS = {"p50": 0.5, "p90": 0.9, "p95": 0.95, "p99": 0.99, "p999": 0.999}


class TelemetryConfig(NamedTuple):
    """Histogram and trace collection knobs.

    Telemetry is off by default at the engine (``telemetry=None``); a
    config turns it on unless ``enabled=False``. ``num_bins`` counts the
    underflow (< ``lo_ms``) and overflow (>= ``hi_ms``) buckets; the
    ``num_bins - 2`` interior bins are log-spaced. ``backend`` is kept and
    validated so that a reference config carries across field by field,
    but it selects nothing: the device does, as in every ``ops.py`` (the
    CUDA kernels for tensors on the card, the plain versions on the CPU).
    ``attribution`` and ``flight`` belong to the attribution slice and
    raise ``NotImplementedError`` when enabled.
    """

    enabled: bool = True
    num_bins: int = 128
    lo_ms: float = 1.0
    hi_ms: float = 10_000.0
    backend: str = "jax"
    attribution: Any = None
    flight: Any = None

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
    config is validated. A disabled attribution or flight sub-config counts
    as absent, as in the reference; an enabled one is not ported yet."""
    if telemetry is None or not telemetry.enabled:
        return None
    telemetry.validate()
    for name in ("attribution", "flight"):
        sub = getattr(telemetry, name)
        if sub is not None and getattr(sub, "enabled", True):
            raise NotImplementedError(
                f"TelemetryConfig.{name} is not ported yet (the attribution slice)"
            )
    return telemetry._replace(attribution=None, flight=None)


class TelemetryLeaves(NamedTuple):
    """Raw per-chunk accumulators, chunk axis first, as numpy arrays after
    the run's one readback. Every field is a sum over requests except the
    point samples ``occupancy``, ``load_factor``, ``unreachable_frac`` and
    ``wiped_frac``. A tier that is off has zero leaves, as in the reference
    (the fault leaves a scalar ``0.0`` on the static whole-trace path)."""

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


# How each leaf merges across a batch axis (seeds, policy rows): "sum"
# leaves add, "mean" point samples average.
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


def merge_leaves(leaves: TelemetryLeaves, axis: int = 0) -> TelemetryLeaves:
    """Merge a batch axis away, leaf by leaf per :data:`LEAF_KINDS`:
    "sum" leaves add, "mean" point samples average."""
    n = np.asarray(leaves.occupancy).shape[axis]
    merged = {}
    for name, kind in LEAF_KINDS.items():
        a = np.asarray(getattr(leaves, name), dtype=np.float64)
        if a.ndim == 0:
            merged[name] = a
        elif kind == "sum":
            merged[name] = a.sum(axis=axis)
        else:
            merged[name] = a.sum(axis=axis) / n
    return TelemetryLeaves(**merged)


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
    ``raw_latency_ms`` is filled by ``run_scenario_reference`` only.
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
    leaves: TelemetryLeaves, cfg: TelemetryConfig, raw_latency_ms: np.ndarray | None = None
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
    return SimTrace(
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
