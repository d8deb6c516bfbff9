"""The system under test, as the benchmark drives it: the configuration and
traffic files turned into the arguments of
``repro_torch.kvsim.run_scenario``, and one scenario replayed on a trace
that the benchmark drew."""

from __future__ import annotations

import math

from repro_torch.kvsim import (ClusterConfig, RedynisPolicy, ServiceConfig, TelemetryConfig, Trace,
                               WorkloadConfig, run_scenario)

__all__ = ["Scenario"]


class Scenario:
    """``run_scenario`` bound to one configuration; ``replay`` runs it on
    a store and a trace (``kvbench.traffic``'s) and returns ``(SimResult,
    SimTrace or None)``."""

    def __init__(self, config: dict):
        n = config["num_nodes"]
        pol = config["policy"]
        if pol["name"] != "redynis":
            raise ValueError(f"unsupported policy {pol['name']!r}")
        self.policy = RedynisPolicy(h=pol["h"], expiry=pol["expiry"], decay=pol["decay"],
                                    period=pol["period"])
        cap = config["capacity_bytes"]
        self.cluster = ClusterConfig(
            num_nodes=n, rtt=tuple(tuple(float(x) for x in row) for row in config["rtt_ms"]),
            service_ms=config["service_ms"], master=config["master"],
            capacity_bytes=math.inf if cap is None else float(cap),
            service=None if config["contention"] is None else ServiceConfig(**config["contention"]))
        tel = config["telemetry"]
        self.telemetry = None if tel is None else TelemetryConfig(**tel)
        self.num_keys, self.num_nodes = config["num_keys"], n
        self.interval = config["daemon_interval"]

    def replay(self, store, requests, num_requests: int | None = None):
        """Replay the first ``num_requests`` requests (all by default)."""
        r = requests.keys.shape[0] if num_requests is None else num_requests
        trace = Trace(requests.keys[:r], requests.nodes[:r], requests.is_read[:r],
                      store.natural_node, store.object_bytes)
        wl = WorkloadConfig(num_requests=r, num_keys=self.num_keys, num_nodes=self.num_nodes)
        out = run_scenario(wl, self.cluster, self.policy, daemon_interval=self.interval,
                           trace=trace, telemetry=self.telemetry, device=requests.keys.device)
        return (out, None) if self.telemetry is None else out

