"""Fault tolerance: heartbeats, failure detection, elastic restart and
straggler mitigation (counterpart of ``src/repro/train/fault.py``; the
paper's §11 "failure handling ... using a heartbeat mechanism").

Node liveness is simulated in one process, but the control logic (the
detector, the elastic width arithmetic, the restore-and-replay
bookkeeping) is what a multi-host run would use. Pure Python beside the
trainer, kept as the port's own copy.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = [
    "HeartbeatMonitor",
    "elastic_data_width",
    "StragglerPolicy",
    "StragglerMonitor",
    "ElasticRunner",
]


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


def elastic_data_width(n_alive: int, model_parallel: int) -> int:
    """The largest data-parallel width a surviving fleet supports: model
    parallel groups are atomic, so the width is the number of complete
    groups (0 when none survives)."""
    return max(n_alive // model_parallel, 0)


class StragglerPolicy(NamedTuple):
    """Backup-step dispatch: a node slower than ``deadline_factor`` x the
    fleet median for ``patience`` steps in a row has its shard re-dispatched
    to the fastest node."""

    deadline_factor: float = 3.0
    patience: int = 2


class StragglerMonitor:
    def __init__(self, nodes: list[str], policy: StragglerPolicy = StragglerPolicy()):
        self.policy = policy
        self.nodes = list(nodes)
        self._slow_streak = {n: 0 for n in nodes}
        self.backup_dispatches: list[tuple[str, str]] = []

    def observe(self, step_times: dict[str, float]) -> list[tuple[str, str]]:
        """Feed one step's per-node times; returns the ``(straggler,
        backup)`` pairs fired this step."""
        med = float(np.median(list(step_times.values())))
        fired = []
        fastest = min(step_times, key=step_times.get)
        for n, t in step_times.items():
            if t > self.policy.deadline_factor * med:
                self._slow_streak[n] += 1
                if self._slow_streak[n] >= self.policy.patience and n != fastest:
                    fired.append((n, fastest))
                    self._slow_streak[n] = 0
            else:
                self._slow_streak[n] = 0
        self.backup_dispatches.extend(fired)
        return fired


class ElasticRunner:
    """Run a training job through simulated node failures.

    ``make_trainer(num_nodes)`` builds ``(trainer, state, pipeline)`` for the
    surviving fleet; on a failure the runner rebuilds at the surviving
    width, restores the latest checkpoint (``trainer.restore`` on a
    generator seeded 0, where the reference passes ``PRNGKey(0)``), which
    seeks the pipeline to its recorded position, and continues."""

    def __init__(self, make_trainer: Callable[[int], tuple], monitor: HeartbeatMonitor,
                 model_parallel: int = 1):
        self.make_trainer = make_trainer
        self.monitor = monitor
        self.model_parallel = model_parallel
        self.restarts = 0

    def run(self, total_steps: int, chunk: int = 10) -> list[dict]:
        n_nodes = len(self.monitor.alive())
        trainer, state, pipeline = self.make_trainer(elastic_data_width(n_nodes, self.model_parallel))
        history: list[dict] = []
        done = 0
        while done < total_steps:
            dead = self.monitor.dead()
            width = elastic_data_width(len(self.monitor.alive()), self.model_parallel)
            if dead and width > 0:
                # Elastic restart at the surviving width from the latest
                # checkpoint; the dead nodes are acknowledged.
                self.restarts += 1
                trainer, state, pipeline = self.make_trainer(width)
                state = trainer.restore(torch.Generator(device=trainer.device).manual_seed(0))
                for n in dead:
                    self.monitor.revive(n)
                self.monitor = HeartbeatMonitor(self.monitor.alive())
            step_n = min(chunk, total_steps - done)
            state, hist = trainer.run(state, pipeline, step_n, log=False)
            history.extend(hist)
            done += step_n
        return history
