"""The paper's testbed (§8) as a trace-driven simulator, in PyTorch:
cluster and workload configs (with the M/M/1 ``ServiceConfig``, per-node
replica-byte budgets, the routing tier's ``RoutingConfig`` and the
failure-injection ``FaultConfig``), trace generation, ``run_scenario``,
``run_experiment`` (the paper's Figure 2/3 grid with 99% CIs over seeds),
the ``run_scenario_reference`` oracle and telemetry (``TelemetryConfig``,
``SimTrace``). The placement policies are re-exported for convenience."""

from repro_torch.core.policy import (
    POLICIES,
    CostGreedyPolicy,
    DecayLFUPolicy,
    RedynisPolicy,
    SizeAwarePolicy,
    StaticPolicy,
    TopKPolicy,
    describe_policy,
    make_policy,
    parse_policy,
)
from repro_torch.kvsim.cluster import (
    WAN5_REGIONS,
    WAN5_RTT_MS,
    ClusterConfig,
    ServiceConfig,
    flat_rtt,
    normalize_service,
    wan5_cluster,
    wan5_edge_cluster,
)
from repro_torch.kvsim.faults import (
    FAULT_KINDS,
    FAULT_MODES,
    FaultConfig,
    FaultEvent,
    blast_radius_rows,
    compile_schedule,
    normalize_faults,
    region_outage,
)
from repro_torch.kvsim.routing import RoutingConfig, normalize_routing
from repro_torch.kvsim.simulate import (
    SimResult,
    confidence_interval_99,
    run_experiment,
    run_scenario,
    run_scenario_reference,
)
from repro_torch.kvsim.telemetry import SimTrace, TelemetryConfig, histogram_quantile
from repro_torch.kvsim.workload import (
    Trace,
    WorkloadConfig,
    diurnal_workload,
    generate_trace,
    wan5_workload,
)

__all__ = [
    "Trace",
    "WorkloadConfig",
    "generate_trace",
    "wan5_workload",
    "diurnal_workload",
    "ClusterConfig",
    "ServiceConfig",
    "normalize_service",
    "RoutingConfig",
    "normalize_routing",
    "FaultConfig",
    "FaultEvent",
    "normalize_faults",
    "FAULT_KINDS",
    "FAULT_MODES",
    "region_outage",
    "compile_schedule",
    "blast_radius_rows",
    "flat_rtt",
    "wan5_cluster",
    "wan5_edge_cluster",
    "WAN5_REGIONS",
    "WAN5_RTT_MS",
    "SimResult",
    "SimTrace",
    "TelemetryConfig",
    "histogram_quantile",
    "run_scenario",
    "run_scenario_reference",
    "run_experiment",
    "confidence_interval_99",
    "POLICIES",
    "CostGreedyPolicy",
    "DecayLFUPolicy",
    "RedynisPolicy",
    "SizeAwarePolicy",
    "StaticPolicy",
    "TopKPolicy",
    "describe_policy",
    "make_policy",
    "parse_policy",
]
