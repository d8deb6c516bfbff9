"""Core Redynis engine in PyTorch: ownership math (eqs. 1-3), the metadata
layer, the placement daemon (``placement``), the placement policies and
their registry (``policy``), the capacity projection with the replication
cost model (``costmodel``), access statistics of ML-state objects
(``traffic``), and plan execution as fused collectives with double
buffering (``repartition``)."""

from repro_torch.core.costmodel import (
    H100_SXM,
    HardwareModel,
    budget_plan,
    project_capacity,
    replication_gain,
)
from repro_torch.core.metadata import (
    MetadataStore,
    create_store,
    local_hit,
    owner_of,
    record_accesses,
    record_new_keys,
)
from repro_torch.core.ownership import (
    eligible_from_fractions,
    eligible_hosts,
    max_coefficient,
    ownership_fraction,
    validate_coefficient,
)
from repro_torch.core.placement import (
    PlacementDaemon,
    PlacementPlan,
    SweepStats,
    apply_plan,
    masked_step,
    redynis_candidates,
    sweep,
)
from repro_torch.core.policy import (
    POLICIES,
    CostGreedyPolicy,
    DecayLFUPolicy,
    PolicyContext,
    RedynisPolicy,
    SizeAwarePolicy,
    StaticPolicy,
    TopKPolicy,
    describe_policy,
    make_policy,
    parse_policy,
    policy_masked_step,
    policy_repr,
    policy_sweep,
    register_policy,
    split_policy,
)
from repro_torch.core.repartition import (
    CommitState,
    Moves,
    ReplicaCache,
    create_cache,
    plan_moves,
    publish_and_fill,
)
from repro_torch.core.traffic import (
    TrafficStats,
    create_stats,
    decay_stats,
    fold_counts,
    fold_events,
)

__all__ = [
    "H100_SXM",
    "HardwareModel",
    "budget_plan",
    "project_capacity",
    "replication_gain",
    "MetadataStore",
    "create_store",
    "local_hit",
    "owner_of",
    "record_accesses",
    "record_new_keys",
    "eligible_from_fractions",
    "eligible_hosts",
    "max_coefficient",
    "ownership_fraction",
    "validate_coefficient",
    "PlacementDaemon",
    "PlacementPlan",
    "SweepStats",
    "apply_plan",
    "masked_step",
    "redynis_candidates",
    "sweep",
    "POLICIES",
    "CostGreedyPolicy",
    "DecayLFUPolicy",
    "PolicyContext",
    "RedynisPolicy",
    "SizeAwarePolicy",
    "StaticPolicy",
    "TopKPolicy",
    "describe_policy",
    "make_policy",
    "parse_policy",
    "policy_masked_step",
    "policy_repr",
    "policy_sweep",
    "register_policy",
    "split_policy",
    "CommitState",
    "Moves",
    "ReplicaCache",
    "create_cache",
    "plan_moves",
    "publish_and_fill",
    "TrafficStats",
    "create_stats",
    "decay_stats",
    "fold_counts",
    "fold_events",
]
