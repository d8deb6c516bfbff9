"""Failure-injection schedules: membership timelines for the simulator
(counterpart of ``src/repro/kvsim/faults.py``; host-side numpy, kept here as
a copy so the port imports nothing of the reference package).

A :class:`FaultConfig` is a declarative list of :class:`FaultEvent`\\ s —
node crashes, zone/region partitions — that :func:`compile_schedule` lowers
into two host-side ``[C, N]`` boolean timelines aligned to the engine's
chunk axis:

  * ``avail[c, n]`` — node ``n`` serves during chunk ``c``. Every consumer
    of the chunk (read fallback, contention, routing) prices against the
    availability-masked map ``hosts_eff = hosts & avail[c]``; the
    write-failover delta and the per-request unavailability verdict come
    from ``kernels.chunk_replay.ref.fault_extra_ms_ref``.
  * ``crash[c, n]`` — node ``n``'s replicas are destroyed at the *start* of
    chunk ``c`` (True only at a crash event's first chunk). ``mode="crash"``
    loses data: keys whose last replica died go dark until the placement
    daemon re-seeds them on its next due tick. ``mode="partition"`` is
    loss-free: the map is untouched and the node's copies serve again the
    chunk the partition heals.

Failure domains: ``kind="node"`` targets one node id; ``kind="zone"`` /
``"region"`` every node whose label in the cluster's ``zone_of`` /
``region_of`` labelling matches. Without a labelling each node is its own
zone and its own region.

Off state: ``faults=None``, ``enabled=False`` and an empty event list all
normalise to ``None``, and the engines run the fault-free program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = [
    "FAULT_KINDS",
    "FAULT_MODES",
    "FaultEvent",
    "FaultConfig",
    "normalize_faults",
    "default_labels",
    "domain_nodes",
    "compile_schedule",
    "event_windows",
    "region_outage",
    "blast_radius_rows",
]

FAULT_KINDS = ("node", "zone", "region")
FAULT_MODES = ("crash", "partition")


class FaultEvent(NamedTuple):
    """One scheduled failure: ``target`` (a node id or a zone/region label,
    per ``kind``) goes down at ``start_chunk`` for ``duration_chunks``
    chunks (``<= 0`` = until the end of the trace)."""

    kind: str = "node"
    target: int = 0
    start_chunk: int = 0
    duration_chunks: int = 0
    mode: str = "crash"

    def validate(self) -> "FaultEvent":
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"FaultEvent.kind must be one of {FAULT_KINDS}, "
                f"got {self.kind!r}"
            )
        if self.mode not in FAULT_MODES:
            raise ValueError(
                f"FaultEvent.mode must be one of {FAULT_MODES}, "
                f"got {self.mode!r}"
            )
        if self.target < 0:
            raise ValueError(f"FaultEvent.target must be >= 0, got {self.target}")
        if self.start_chunk < 0:
            raise ValueError(
                f"FaultEvent.start_chunk must be >= 0, got {self.start_chunk}"
            )
        return self


class FaultConfig(NamedTuple):
    """Declarative fault schedule (hangs off ``ClusterConfig.faults``).

    Hashable (a jit-static rides on the cluster config) and off-by-default:
    ``normalize_faults`` collapses disabled/empty configs to ``None``.
    """

    enabled: bool = True
    events: tuple[FaultEvent, ...] = ()

    def validate(self) -> "FaultConfig":
        for ev in self.events:
            if not isinstance(ev, FaultEvent):
                raise TypeError(
                    "FaultConfig.events must be FaultEvent instances, "
                    f"got {type(ev).__name__}"
                )
            ev.validate()
        return self


def normalize_faults(faults: "FaultConfig | None") -> "FaultConfig | None":
    """Collapse every off state to ``None`` (the house off-by-default
    pattern): ``None``, ``enabled=False``, and an empty event list all
    compile the identical fault-free program."""
    if faults is None:
        return None
    faults.validate()
    if not faults.enabled or not faults.events:
        return None
    return faults


def default_labels(num_nodes: int) -> tuple[int, ...]:
    """The flat hierarchy: each node is its own zone and its own region."""
    return tuple(range(num_nodes))


def _labels_for(
    kind: str,
    num_nodes: int,
    zone_of: tuple[int, ...] | None,
    region_of: tuple[int, ...] | None,
) -> tuple[int, ...]:
    if kind == "node":
        return default_labels(num_nodes)
    labels = zone_of if kind == "zone" else region_of
    return default_labels(num_nodes) if labels is None else tuple(labels)


def domain_nodes(
    event: FaultEvent,
    *,
    num_nodes: int,
    zone_of: tuple[int, ...] | None = None,
    region_of: tuple[int, ...] | None = None,
) -> np.ndarray:
    """``[N] bool`` — the nodes inside the event's failure domain."""
    labels = _labels_for(event.kind, num_nodes, zone_of, region_of)
    if len(labels) != num_nodes:
        raise ValueError(
            f"{event.kind} labelling has {len(labels)} entries for "
            f"{num_nodes} nodes"
        )
    mask = np.asarray(labels) == event.target
    if not mask.any():
        raise ValueError(
            f"FaultEvent targets {event.kind} {event.target}, which labels "
            "no node"
        )
    return mask


def event_windows(
    faults: FaultConfig, num_chunks: int
) -> list[tuple[FaultEvent, int, int]]:
    """Each event clipped to the trace: ``(event, start, end)`` half-open
    chunk windows (events entirely past the trace end are dropped)."""
    out = []
    for ev in faults.events:
        start = ev.start_chunk
        if start >= num_chunks:
            continue
        end = num_chunks if ev.duration_chunks <= 0 else min(
            num_chunks, start + ev.duration_chunks
        )
        if end > start:
            out.append((ev, start, end))
    return out


def compile_schedule(
    faults: FaultConfig,
    *,
    num_nodes: int,
    num_chunks: int,
    zone_of: tuple[int, ...] | None = None,
    region_of: tuple[int, ...] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Lower the declarative schedule to ``(avail [C, N], crash [C, N])``
    boolean timelines (host-side numpy; the engines embed them as scan
    constants). ``avail`` ANDs over every active event's domain; ``crash``
    is True only at a crash event's start chunk (the one-shot replica wipe
    — re-crashing an already-down node is idempotent)."""
    faults.validate()
    avail = np.ones((num_chunks, num_nodes), dtype=bool)
    crash = np.zeros((num_chunks, num_nodes), dtype=bool)
    for ev, start, end in event_windows(faults, num_chunks):
        mask = domain_nodes(
            ev, num_nodes=num_nodes, zone_of=zone_of, region_of=region_of
        )
        avail[start:end, mask] = False
        if ev.mode == "crash":
            crash[start, mask] = True
    if not avail.any(axis=1).all():
        dark = int(np.argmin(avail.any(axis=1)))
        raise ValueError(
            f"fault schedule leaves no node available at chunk {dark} — "
            "the failover master election needs at least one live node"
        )
    return avail, crash


def region_outage(
    target: int,
    start_chunk: int,
    duration_chunks: int,
    *,
    mode: str = "crash",
) -> FaultConfig:
    """Convenience: the bench's canonical single-region outage drill."""
    return FaultConfig(
        events=(
            FaultEvent(
                kind="region",
                target=target,
                start_chunk=start_chunk,
                duration_chunks=duration_chunks,
                mode=mode,
            ),
        )
    )


def blast_radius_rows(
    faults: FaultConfig,
    *,
    num_chunks: int,
    unreachable_frac: np.ndarray,  # [C] fraction of keys with no live replica
    wiped_frac: np.ndarray,  # [C] fraction of keys that lost every replica
) -> list[dict]:
    """Per-scheduled-failure blast radius: for each event window, the peak
    fraction of keys left with no live replica (``unreachable``) and no
    surviving replica at all (``wiped``) — read off the engine's per-chunk
    fault telemetry series."""
    rows = []
    for ev, start, end in event_windows(faults, num_chunks):
        rows.append(
            {
                "kind": ev.kind,
                "target": int(ev.target),
                "mode": ev.mode,
                "start_chunk": int(start),
                "end_chunk": int(end),
                "blast_radius_unreachable": float(
                    np.max(unreachable_frac[start:end])
                ),
                "blast_radius_wiped": float(np.max(wiped_frac[start:end])),
            }
        )
    return rows
