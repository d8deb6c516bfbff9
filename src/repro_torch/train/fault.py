"""Heartbeat failure detection (counterpart of ``HeartbeatMonitor`` in
``src/repro/train/fault.py``; the paper's §11 "failure handling ... using a
heartbeat mechanism"). Pure Python, kept as the port's own copy. The
elastic restart and straggler machinery of that module come with the
training slice."""

from __future__ import annotations

import time

__all__ = ["HeartbeatMonitor"]


class HeartbeatMonitor:
    """A node is DOWN when its heartbeat is older than ``timeout`` seconds.
    Real deployments feed this from an RPC mesh; tests feed it manually.
    The same detector drives the serving router's leader election."""

    def __init__(self, nodes: list[str], timeout: float = 5.0):
        self.timeout = timeout
        self._last: dict[str, float] = {n: time.monotonic() for n in nodes}
        self._forced_down: set[str] = set()

    def beat(self, node: str, at: float | None = None) -> None:
        if node in self._forced_down:
            return
        self._last[node] = time.monotonic() if at is None else at

    def kill(self, node: str) -> None:
        """Simulated hard failure: heartbeats stop permanently."""
        self._forced_down.add(node)
        self._last[node] = -float("inf")

    def revive(self, node: str) -> None:
        self._forced_down.discard(node)
        self.beat(node)

    def alive(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [n for n, t in self._last.items() if now - t <= self.timeout]

    def dead(self, now: float | None = None) -> list[str]:
        now = time.monotonic() if now is None else now
        return [n for n, t in self._last.items() if now - t > self.timeout]
