"""Session-affinity router — Redynis integration #3, the serving control
plane (counterpart of ``src/repro/serving/router.py``).

Objects are sessions (their KV decode state), nodes are pods, traffic is
request arrivals. The router keeps the paper's metadata layer (per-session
per-pod access counts, last-access time) on the engine's device, and its
placement daemon decides which pod owns each session's cache: its sweeps
run the ``ownership_sweep`` kernel on the card, migrating caches toward
the pods that serve them most and expiring idle sessions, with the
migration payload charged at the decode state's real byte size.

Leader election (paper §11): the pod that commits placement changes is
chosen by a bully election over the heartbeat table (highest-id live pod);
a dead leader is replaced on the next ``tick()``. Sweeps run on the
leader, as the paper's single RedynisDaemon node does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.metadata import create_store, record_accesses, record_new_keys
from repro_torch.core.placement import PlacementDaemon
from repro_torch.train.fault import HeartbeatMonitor

__all__ = ["RouteResult", "SessionRouter"]


class RouteResult(NamedTuple):
    pod: int  # pod that serves the request
    local_hit: bool  # session cache already on that pod
    migrated: bool  # placement moved the cache here first


def _pod_ids(names: list[str]) -> set[int]:
    return {int(n.split("-")[1]) for n in names}


class SessionRouter:
    def __init__(
        self,
        num_pods: int,
        max_sessions: int,
        *,
        h: float | None = None,
        expiry_ticks: int | None = 10_000,
        sweep_period: int = 100,
        session_bytes: float = 0.0,
        device=None,
    ):
        """``device`` holds the metadata store (``None`` means CUDA)."""
        self.num_pods = num_pods
        self.max_sessions = max_sessions
        self.daemon = PlacementDaemon(num_pods, h=h, expiry=expiry_ticks, period=sweep_period)
        self.store = create_store(max_sessions, num_pods, device)
        self.session_bytes = session_bytes
        self._sid: dict[str, int] = {}  # session name -> key index
        self._free = list(range(max_sessions - 1, -1, -1))
        self.monitor = HeartbeatMonitor([f"pod-{i}" for i in range(num_pods)])
        self.leader = self._elect()
        self.tick_count = 0
        self.stats = {
            "requests": 0,
            "local_hits": 0,
            "migrations": 0,
            "migrated_bytes": 0.0,
            "expired": 0,
            "elections": 0,
        }

    # ------------------------------------------------------------ election
    def _elect(self) -> int:
        """Bully election: the highest-id live pod becomes the serializer."""
        alive = self.monitor.alive()
        if not alive:
            raise RuntimeError("no live pods")
        return max(_pod_ids(alive))

    def fail_pod(self, pod: int) -> None:
        """Simulated pod failure: sessions homed there lose their replicas
        (one that lost its only replica must re-prefill elsewhere); a dead
        leader is replaced on the next tick."""
        self.monitor.kill(f"pod-{pod}")
        hosts = self.store.hosts.clone()
        hosts[:, pod] = False
        orphan = ~hosts.any(dim=-1) & self.store.live
        self.store = self.store._replace(hosts=hosts, live=self.store.live & ~orphan)

    # ------------------------------------------------------------ routing
    def _key_of(self, session: str) -> int:
        if session not in self._sid:
            if not self._free:
                raise RuntimeError("session table full")
            self._sid[session] = self._free.pop()
        return self._sid[session]

    def route(self, session: str, source_pod: int) -> RouteResult:
        """Algorithm 1, serving flavour: serve locally when the cache is
        here; otherwise from the owner pod while the metadata layer logs the
        miss — the daemon migrates hot sessions at the next sweep."""
        alive = _pod_ids(self.monitor.alive())
        if source_pod not in alive:
            source_pod = min(alive)
        key = self._key_of(session)
        dev = self.store.live.device
        k = torch.tensor([key], dtype=torch.int32, device=dev)
        n = torch.tensor([source_pod], dtype=torch.int32, device=dev)
        self.stats["requests"] += 1

        if not bool(self.store.live[key]):  # new session: cache built where it landed
            self.store = record_new_keys(self.store, k, n, now=self.tick_count)
            return RouteResult(pod=source_pod, local_hit=False, migrated=False)

        self.store = record_accesses(self.store, k, n, now=self.tick_count)
        hosts = self.store.hosts[key].cpu()
        if bool(hosts[source_pod]):
            self.stats["local_hits"] += 1
            return RouteResult(pod=source_pod, local_hit=True, migrated=False)
        owner = int(torch.argmax(hosts.to(torch.int8)))  # the first holder
        return RouteResult(pod=owner, local_hit=False, migrated=False)

    # ------------------------------------------------------------ daemon
    def tick(self) -> None:
        """Advance logical time; on the period boundary the leader sweeps."""
        self.tick_count += 1
        for i in range(self.num_pods):  # healthy pods heartbeat every tick
            self.monitor.beat(f"pod-{i}")
        if int(self.leader) not in _pod_ids(self.monitor.alive()):
            self.leader = self._elect()
            self.stats["elections"] += 1
        if self.tick_count % self.daemon.period == 0:
            plan, self.store = self.daemon.step(self.store, now=self.tick_count)
            moves = int(plan.to_add.sum())
            self.stats["migrations"] += moves
            self.stats["migrated_bytes"] += moves * self.session_bytes
            self.stats["expired"] += int(plan.expired.sum())

    # ------------------------------------------------------------ metrics
    def hit_rate(self) -> float:
        return self.stats["local_hits"] / max(self.stats["requests"], 1)
