"""Flight-recorder export: JSON lines and the Chrome trace-event format
(counterpart of ``src/repro/kvsim/tracing.py``; the same files for the same
records).

``SimTrace.flight_records()`` gives the sampled requests as plain dicts
(trace position, key, node, router, read or write, and the eight latency
components of ``COMPONENTS``). This module writes them:

* :func:`write_jsonl` — one JSON object a line
  (``pd.read_json(path, lines=True)``);
* :func:`write_chrome_trace` — a Chrome trace-event document, loadable in
  ``chrome://tracing`` and Perfetto (https://ui.perfetto.dev). The
  simulator has no wall clock, so each sampled request is a complete event
  (``"ph": "X"``) on a virtual timeline: its timestamp is its trace
  position (one position, one virtual millisecond), its duration its
  modelled latency, ``pid`` its node and ``tid`` its router (0 with routing
  off); the components ride in ``args``. The document's ``otherData``
  names the package that wrote it; all else is the reference's bytes.

Plain Python over host-side dicts; nothing here touches a device.
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping

__all__ = [
    "chrome_trace_events",
    "write_chrome_trace",
    "write_jsonl",
]

# 1 trace position == 1 virtual millisecond == 1000 trace-event µs ticks.
_US_PER_POSITION = 1000.0


def write_jsonl(records: Iterable[Mapping], path: str) -> int:
    """Write flight records as JSON-lines; returns the record count."""
    n = 0
    with open(path, "w") as fh:
        for rec in records:
            fh.write(json.dumps(dict(rec)) + "\n")
            n += 1
    return n


def chrome_trace_events(records: Iterable[Mapping]) -> dict:
    """Flight records -> a Chrome trace-event JSON document (as a dict).

    Returns ``{"traceEvents": [...], "displayTimeUnit": "ms", ...}`` ready
    for ``json.dump``. See the module docstring for the virtual-timeline
    and pid/tid conventions.
    """
    events = []
    nodes = set()
    for rec in records:
        node = int(rec["node"])
        router = int(rec.get("router", -1))
        nodes.add(node)
        events.append(
            {
                "name": "read" if rec["is_read"] else "write",
                "cat": "request",
                "ph": "X",
                "ts": float(rec["pos"]) * _US_PER_POSITION,
                "dur": float(rec["total_ms"]) * 1000.0,
                "pid": node,
                "tid": max(router, 0),
                "args": {
                    "key": int(rec["key"]),
                    "chunk": int(rec["chunk"]),
                    "router": router,
                    **{
                        name: float(val)
                        for name, val in rec["components"].items()
                    },
                },
            }
        )
    # Metadata events name the node tracks so Perfetto shows "node 0" etc.
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": node,
            "args": {"name": f"node {node}"},
        }
        for node in sorted(nodes)
    ]
    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {
            "source": "repro_torch.kvsim flight recorder",
            "timeline": "virtual (1 trace position = 1 ms)",
        },
    }


def write_chrome_trace(records: Iterable[Mapping], path: str) -> int:
    """Write flight records as a Chrome/Perfetto trace file; returns the
    number of request events written."""
    doc = chrome_trace_events(records)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1)
    return sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
