"""The paper's testbed (§8) as a trace-driven simulator, in PyTorch:
cluster and workload configs (with the M/M/1 ``ServiceConfig``, per-node
replica-byte budgets, the routing tier's ``RoutingConfig`` and the
failure-injection ``FaultConfig``), trace generation, ``run_scenario``,
``run_experiment`` (the paper's Figure 2/3 grid with 99% CIs over seeds),
the ``run_scenario_reference`` oracle, telemetry (``TelemetryConfig``,
``SimTrace``) with cost attribution and the flight recorder
(``AttributionConfig``, ``FlightRecorderConfig``; export through
``write_jsonl`` and ``write_chrome_trace``), and streamed traces
(``generate_key_state``, ``generate_trace_chunk``,
``run_scenario(..., trace_mode="streamed")``), and the key-sharded engine
(``run_scenario(..., num_shards=S)`` on each rank of a ``torch.distributed``
group, ``ShardSpec``; ``repro_torch.spmd.run_ranks`` starts the ranks). The
placement policies are re-exported for convenience; a legacy ``Scenario``
passed as a policy raises, naming its replacement."""

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
    TRACE_MODES,
    Scenario,
    ShardSpec,
    SimResult,
    confidence_interval_99,
    run_experiment,
    run_scenario,
    run_scenario_reference,
)
from repro_torch.kvsim.telemetry import (
    COMPONENTS,
    NUM_COMPONENTS,
    QUANTILE_LABELS,
    AttributionConfig,
    FlightRecorderConfig,
    SimTrace,
    TelemetryConfig,
    histogram_quantile,
)
from repro_torch.kvsim.tracing import chrome_trace_events, write_chrome_trace, write_jsonl
from repro_torch.kvsim.workload import (
    Trace,
    TraceChunk,
    WorkloadConfig,
    diurnal_workload,
    generate_key_state,
    generate_trace,
    generate_trace_chunk,
    wan5_workload,
)

__all__ = [
    "Trace",
    "TraceChunk",
    "WorkloadConfig",
    "generate_trace",
    "generate_trace_chunk",
    "generate_key_state",
    "wan5_workload",
    "diurnal_workload",
    "TRACE_MODES",
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
    "ShardSpec",
    "SimResult",
    "Scenario",
    "SimTrace",
    "TelemetryConfig",
    "AttributionConfig",
    "FlightRecorderConfig",
    "COMPONENTS",
    "NUM_COMPONENTS",
    "histogram_quantile",
    "QUANTILE_LABELS",
    "chrome_trace_events",
    "write_chrome_trace",
    "write_jsonl",
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
