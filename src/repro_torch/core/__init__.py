"""Core Redynis engine in PyTorch: ownership math (eqs. 1-3), the metadata
layer and placement plans (the daemon's ``sweep`` and ``PlacementDaemon``
stay in ``core.placement``). The policies (``core.policy``) run the
``ownership_sweep`` kernel, whose plain version imports this package, so
they are not re-exported here; ``repro_torch.kvsim`` re-exports them."""

from repro_torch.core.metadata import MetadataStore, create_store, record_accesses
from repro_torch.core.ownership import (
    eligible_from_fractions,
    eligible_hosts,
    max_coefficient,
    ownership_fraction,
    validate_coefficient,
)
from repro_torch.core.placement import PlacementPlan, SweepStats, redynis_candidates

__all__ = [
    "MetadataStore",
    "create_store",
    "record_accesses",
    "eligible_from_fractions",
    "eligible_hosts",
    "max_coefficient",
    "ownership_fraction",
    "validate_coefficient",
    "PlacementPlan",
    "SweepStats",
    "redynis_candidates",
]
