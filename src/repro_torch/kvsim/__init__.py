"""The paper's testbed (§8) as a trace-driven simulator, in PyTorch:
cluster and workload configs, trace generation, and ``run_scenario``.
The baseline policies are re-exported for convenience."""

from repro_torch.core.policy import RedynisPolicy, StaticPolicy
from repro_torch.kvsim.cluster import (
    WAN5_REGIONS,
    WAN5_RTT_MS,
    ClusterConfig,
    flat_rtt,
    wan5_cluster,
)
from repro_torch.kvsim.simulate import SimResult, run_scenario
from repro_torch.kvsim.workload import (
    Trace,
    WorkloadConfig,
    diurnal_workload,
    generate_trace,
    wan5_workload,
)

__all__ = [
    "RedynisPolicy",
    "StaticPolicy",
    "WAN5_REGIONS",
    "WAN5_RTT_MS",
    "ClusterConfig",
    "flat_rtt",
    "wan5_cluster",
    "SimResult",
    "run_scenario",
    "Trace",
    "WorkloadConfig",
    "diurnal_workload",
    "generate_trace",
    "wan5_workload",
]
