"""The traced window: ``torch.profiler`` over the window with CUDA activity
only (CUPTI's kernel, copy and memset records and the host's runtime calls;
no operator records, which would cost the host a few microseconds an
operator), read from the raw event list, and reduced to what the per-layer
metrics and the ``device`` and ``breakdown`` fields of a result read."""

from __future__ import annotations

import bisect
from typing import NamedTuple

__all__ = ["Window", "reduce_events", "union_ns", "breakdown", "LAUNCH_PREFIXES"]

# Runtime and driver calls that start a kernel on the device.
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


class Window(NamedTuple):
    """One traced window, on the profiler's clock (ns)."""

    device_ops: list  # (name, start, end, correlation) of kernels, copies, memsets
    runtime: list  # (name, start, end, correlation) of the host's runtime calls
    window_s: float  # host clock over the window
    ticks: int  # daemon ticks the window ran
    context: dict  # the cell: "config", "traffic", "requests" (each scenario's trace), ...

    @property
    def launches(self) -> int:
        return sum(1 for name, *_ in self.runtime if name.startswith(LAUNCH_PREFIXES))

    @property
    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e, _ in self.device_ops]) / 1e9

    def kernels(self, part: str) -> list:
        """The device operations whose name holds ``part``."""
        return [op for op in self.device_ops if part in op[0]]


def reduce_events(events, window_s: float, ticks: int, context: dict) -> Window:
    """A :class:`Window` from ``prof.profiler.kineto_results.events()``."""
    from torch.autograd import DeviceType

    device_ops, runtime = [], []
    for e in events:
        start = e.start_ns()
        row = (e.name(), start, start + e.duration_ns(), e.correlation_id())
        (device_ops if e.device_type() == DeviceType.CUDA else runtime).append(row)
    device_ops.sort(key=lambda op: op[1])
    runtime.sort(key=lambda op: op[1])
    return Window(device_ops, runtime, window_s, ticks, context)


def union_ns(intervals) -> int:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# Namespaces and keywords that say nothing of which kernel a name is.
_NOISE = ("void ", "at::native::", "at_cuda_detail::cub::", "at::cuda::cub::detail::",
          "(anonymous namespace)::", "::operator()() const", "at::", "std::")


def _short(name: str, width: int = 120) -> str:
    for noise in _NOISE:
        name = name.replace(noise, "")
    return name if len(name) <= width else name[: width - 3] + "..."


def breakdown(win: Window, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    summed by what the host was doing: the last runtime call it had started
    when the gap began, and the operation that ended the gap."""
    by_op: dict = {}
    for name, s, e, _ in win.device_ops:
        by_op[name] = by_op.get(name, 0) + e - s
    launcher = {corr: name for name, _, _, corr in win.runtime}
    starts = [s for _, s, _, _ in win.runtime]
    gaps: dict = {}
    end = None
    for name, s, e, corr in win.device_ops:
        if end is not None and s > end:
            i = bisect.bisect_right(starts, end) - 1
            host = win.runtime[i][0] if i >= 0 else "start"
            label = f"host in {host}; then {launcher.get(corr, '?')}: {_short(name, 80)}"
            gaps[label] = gaps.get(label, 0) + s - end
        end = e if end is None else max(end, e)
    rank = lambda d: sorted(([_short(k), v / 1e9] for k, v in d.items()), key=lambda x: -x[1])[:top]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}
