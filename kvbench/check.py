"""The comparison that decides ``correct``: the answers of a replayed
scenario against the reference's answers for the same trace.

Two numbers, each held to a limit of the configuration's ``limits``:

* ``counts_off``: how many exact answers differ. The moves by kind, and
  with telemetry every bin of the run's ``[2N, B]`` histogram, every bin of
  each chunk's ``[B]`` histogram, and each chunk's requests, moves, drops,
  expiry evictions and capacity evictions.
* ``rel_gap``: the widest relative gap of the float answers. Throughput,
  hit rate, mean latency, busy time and peak occupancy of each node, and
  with telemetry each chunk's hit rate, mean latency and P99, the run's
  P50 to P99.9, and each chunk's occupancy and load factor of each node.
  A gap is taken against the larger of the reference's own value and the
  median magnitude of its field, so that a value near zero does not blow
  it up.
"""

from __future__ import annotations

import numpy as np

from kvbench.reference.engine import QUANTILES, bin_edges, quantile_rows

__all__ = ["program_answers", "reference_answers", "compare", "NUMBERS"]

NUMBERS = ("counts_off", "rel_gap")


def program_answers(result, trace, config: dict) -> dict:
    """The program's ``SimResult`` and ``SimTrace`` (``None`` with telemetry
    off) as ``(exact, floats)`` dicts of numpy arrays."""
    exact = {"moves": np.array([result.replication_moves, result.deletion_moves,
                                result.evictions, result.capacity_evictions])}
    floats = {
        "throughput_ops_s": np.array([result.throughput_ops_s]),
        "hit_rate": np.array([result.hit_rate]),
        "mean_latency_ms": np.array([result.mean_latency_ms]),
        "node_busy_ms": np.asarray(result.node_busy_ms),
        "peak_occupancy_bytes": np.asarray(result.peak_occupancy_bytes),
    }
    if config.get("telemetry") is not None:
        exact.update(
            hist_group=np.asarray(trace.hist_group), chunk_hist=np.asarray(trace.chunk_hist),
            requests=np.asarray(trace.requests), adds=np.asarray(trace.moves),
            drops=np.asarray(trace.drops), expired=np.asarray(trace.evictions),
            capacity_evictions=np.asarray(trace.capacity_evictions))
        floats.update(
            chunk_hit_rate=np.asarray(trace.hit_rate),
            chunk_mean_latency_ms=np.asarray(trace.mean_latency_ms),
            chunk_p99_ms=np.asarray(trace.p99_latency_ms),
            tail_ms=np.array(trace.quantiles(QUANTILES)),
            occupancy_bytes=np.asarray(trace.occupancy_bytes),
            load_factor=np.asarray(trace.load_factor))
    return {"exact": exact, "floats": floats}


def reference_answers(ref: dict, config: dict) -> dict:
    """The reference's answers (``engine.replay``'s dict) in the same form."""
    exact = {"moves": ref["moves"]}
    floats = {name: np.atleast_1d(np.asarray(ref[name], dtype=np.float64)) for name in (
        "throughput_ops_s", "hit_rate", "mean_latency_ms", "node_busy_ms", "peak_occupancy_bytes")}
    tel = config.get("telemetry")
    if tel is not None:
        edges = bin_edges(tel["lo_ms"], tel["hi_ms"], tel["num_bins"])
        hist = ref["hist"]  # [C, 2N, B]
        chunk_hist = hist.sum(axis=1)
        whole = hist.sum(axis=(0, 1))[None, :]
        exact.update(
            hist_group=hist.sum(axis=0), chunk_hist=chunk_hist, requests=ref["count"],
            adds=ref["adds"], drops=ref["drops"], expired=ref["expired"],
            capacity_evictions=ref["capacity_evictions"])
        count = np.maximum(ref["count"].astype(np.float64), 1.0)
        floats.update(
            chunk_hit_rate=ref["hits"] / np.maximum(ref["reads"].astype(np.float64), 1.0),
            chunk_mean_latency_ms=ref["lat_sum"] / count,
            chunk_p99_ms=quantile_rows(chunk_hist, edges, 0.99),
            tail_ms=np.array([quantile_rows(whole, edges, q)[0] for q in QUANTILES]),
            occupancy_bytes=ref["occupancy"], load_factor=ref["load_factor"])
    return {"exact": exact, "floats": floats}


def compare(got: dict, want: dict) -> dict:
    """``{"counts_off": int, "rel_gap": float, "worst": field}``; a field
    missing or of another shape counts as wholly off."""
    off = 0
    for name, w in want["exact"].items():
        g = got["exact"].get(name)
        w = np.asarray(w, dtype=np.float64)
        if g is None or np.shape(g) != w.shape:
            off += w.size
        else:
            off += int(np.count_nonzero(np.asarray(g, dtype=np.float64) != w))
    gap, worst = 0.0, ""
    for name, w in want["floats"].items():
        w = np.asarray(w, dtype=np.float64)
        g = got["floats"].get(name)
        if g is None or np.shape(g) != w.shape:
            field_gap = float("inf")
        else:
            g = np.asarray(g, dtype=np.float64)
            finite = np.isfinite(w)
            if not np.array_equal(finite, np.isfinite(g)):
                field_gap = float("inf")
            elif not finite.any():
                field_gap = 0.0
            else:
                scale = np.maximum(np.abs(w[finite]), np.median(np.abs(w[finite])))
                diff = np.abs(g[finite] - w[finite])
                field_gap = float(np.max(np.where(diff == 0, 0.0, diff / np.maximum(scale, 1e-300))))
        if field_gap > gap:
            gap, worst = field_gap, name
    return {"counts_off": off, "rel_gap": gap, "worst": worst}
