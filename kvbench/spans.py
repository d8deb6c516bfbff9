"""The program's own spans and counters (``repro_torch.obs``) joined to a
traced window, for the per-layer metrics that split the daemon tick by
stage.

``repro_torch.kvsim.run_scenario`` records its stages while the profiler
collects, on the clock the profiler stamps its host records with. Here each
device operation is joined to the runtime call that launched it (by
``correlation``) and attributed to the innermost span whose host interval
holds that call's start; a span's device time includes its children's.
Device time launched outside every span, or by no runtime call the trace
holds, is untraced: the program's coverage, which its tests hold at 0. The
host's time inside ``chunk`` spans is split into its runtime calls and its
own, and the device's idle time into the part while the host is inside a
``chunk`` span and the rest. Per-tick figures divide by the program's
counters (``chunks``, ``sweeps``), not by the harness's tick arithmetic.

:func:`attribute` returns ``None`` where there is nothing to read: a
program without ``repro_torch.obs``, or a window with no recorded
scenario; the readers then return ``None`` and the metric is left out."""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["Attribution", "attribute", "merge", "overlap_ns", "RUNTIME_PREFIX"]

# CUDA API calls (cuda* and cu*): the host waiting on or feeding
# the card. Other host records (a profiler step's annotation) are not.
RUNTIME_PREFIX = "cu"


class Attribution(NamedTuple):
    """A traced window's device and host time by the program's spans (ns)."""

    device_ns: dict  # span name -> device time launched inside its spans, children included
    untraced_ns: int  # device time launched outside every span, or by no runtime call seen
    total_ns: int  # all device time of the window
    counters: dict  # the program's counters summed over the window's scenarios
    chunk_ns: int  # the host's time inside chunk spans
    chunk_runtime_ns: int  # ... of it inside runtime calls
    idle_in_chunk_ns: int  # ... of it with no device operation running


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def overlap_ns(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _recorded():
    try:
        from repro_torch import obs
    except ImportError:  # a program without spans
        return None
    return obs.recorded()


def _innermost(spans, parents, times) -> list:
    """For each of the sorted ``times``, the index of the innermost span
    ``(start, end)`` that holds it, or -1. ``spans`` are in start order,
    each after its parent (``parents[i]``, -1 at a root), properly nested."""
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1] != parents[k]:
                stack.pop()
            stack.append(k)
            k += 1
        while stack and spans[stack[-1]][1] <= t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def _attribute(win, records) -> Attribution | None:
    runtime = [r for r in win.runtime if r[0].startswith(RUNTIME_PREFIX)]
    if not runtime or not win.device_ops:
        return None
    t0, t1 = runtime[0][1], max(e for _, _, e, _ in runtime)
    # The window's scenarios: those whose root span overlaps its runtime calls.
    records = [r for r in records
               if r.spans and r.spans[0].start_ns < t1 and r.spans[0].end_ns > t0]
    if not records:
        return None
    spans, parents, names, counters = [], [], [], {}
    for rec in records:
        base = len(spans)
        for s in rec.spans:
            spans.append((s.start_ns, s.end_ns))
            parents.append(-1 if s.parent < 0 else base + s.parent)
            names.append(s.name)
        for key, value in rec.counters.items():
            counters[key] = counters.get(key, 0) + value
    order = sorted(range(len(spans)), key=lambda i: (spans[i][0], i))
    rank = {i: r for r, i in enumerate(order)}
    sorted_spans = [spans[i] for i in order]
    sorted_parents = [-1 if parents[i] < 0 else rank[parents[i]] for i in order]
    inner = _innermost(sorted_spans, sorted_parents, [s for _, s, _, _ in runtime])
    span_of = {corr: (-1 if j < 0 else order[j]) for (_, _, _, corr), j in zip(runtime, inner)}

    own = [0] * len(spans)
    untraced = total = 0
    for _, s, e, corr in win.device_ops:
        total += e - s
        i = span_of.get(corr, -1)
        if i < 0:
            untraced += e - s
        else:
            own[i] += e - s
    for i in range(len(spans) - 1, -1, -1):  # a child after its parent: fold upwards
        if parents[i] >= 0:
            own[parents[i]] += own[i]
    device_ns = {}
    for name, ns in zip(names, own):
        device_ns[name] = device_ns.get(name, 0) + ns

    chunks = merge(span for span, name in zip(spans, names) if name == "chunk")
    chunk_ns = sum(e - s for s, e in chunks)
    calls = merge((s, e) for _, s, e, _ in runtime)
    busy = merge((s, e) for _, s, e, _ in win.device_ops)
    return Attribution(
        device_ns=device_ns, untraced_ns=untraced, total_ns=total, counters=counters,
        chunk_ns=chunk_ns, chunk_runtime_ns=overlap_ns(chunks, calls),
        idle_in_chunk_ns=chunk_ns - overlap_ns(chunks, busy))


_last: tuple = (None, None)  # (window and recording key, its Attribution): the readers share it


def attribute(win, records=None) -> Attribution | None:
    """The :class:`Attribution` of ``win``, from ``records`` (by default
    what ``repro_torch.obs`` recorded), or ``None`` with nothing to read."""
    global _last
    records = _recorded() if records is None else records
    if records is None:
        return None
    key = (win.window_s, len(win.device_ops), len(win.runtime), win.device_ops[:1],
           win.device_ops[-1:], [(r.id, len(r.spans), r.counters) for r in records])
    if _last[0] != key:
        _last = (key, _attribute(win, records))
    return _last[1]
