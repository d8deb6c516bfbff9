"""Placement plans and the placement daemon — the paper's Algorithm 3
(counterpart of ``src/repro/core/placement.py``).

``sweep`` runs the analysis pass through the ``ownership_sweep`` kernel
(fractions, eligibility with the starvation guard, silence keeps the
placement, expiry and live mask, the moves) whatever ``backend`` names:
the reference's two backends compute the same plan. Then the optional
availability mask, the capacity projection (``core/costmodel.py``) scored
by the kernel's ``f`` when ``capacity_bytes`` is given (``None`` skips it:
bit-exact Algorithm 3), and the store update. ``apply_plan`` enforces a
plan on a presence mask; ``masked_step`` commits a sweep only on a due
tick; ``PlacementDaemon`` drives ``sweep`` every ``period`` ticks with the
post-sweep count decay. The chunk engine's policy step is
``core/policy.py::policy_masked_step``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.costmodel import project_capacity
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.ownership import eligible_from_fractions, validate_coefficient

__all__ = [
    "PlacementPlan",
    "SweepStats",
    "SWEEP_BACKENDS",
    "redynis_candidates",
    "sweep",
    "apply_plan",
    "masked_step",
    "PlacementDaemon",
]

SWEEP_BACKENDS = ("jax", "pallas")


class PlacementPlan(NamedTuple):
    """Output of one analysis pass (Algorithm 3 steps 1-3)."""

    owners: torch.Tensor  # [K, N] bool  -- post-sweep replica set
    to_add: torch.Tensor  # [K, N] bool  -- owners - current
    to_drop: torch.Tensor  # [K, N] bool -- current - owners
    expired: torch.Tensor  # [K]   bool  -- keys past expiry
    f: torch.Tensor | None = None  # [K, N] f32 ownership fractions
    capacity_evicted: torch.Tensor | None = None  # [K, N] bool; None: no budget


class SweepStats(NamedTuple):
    """Move accounting for one daemon step (0-dim int64 device tensors; the
    reference's are f32 counts)."""

    adds: torch.Tensor  # replicas created
    drops: torch.Tensor  # replicas dropped (threshold + expiry)
    expiry_evictions: torch.Tensor  # drops attributable to key expiry
    capacity_evictions: torch.Tensor  # held replicas evicted by a budget


def _expiry_enabled(expiry: int | None) -> bool:
    """``None`` and ``0`` both disable expiry."""
    return expiry is not None and expiry > 0


def redynis_candidates(store: MetadataStore, f: torch.Tensor, h: float) -> torch.Tensor:
    """Algorithm 3's candidate replica set from precomputed fractions:
    eligibility (eq. 2 + starvation guard), silence keeps the current
    placement, dead keys own nothing."""
    counts, hosts, live = store.access_counts, store.hosts, store.live
    eligible = eligible_from_fractions(f, counts, h)
    touched = counts.sum(dim=-1) > 0
    owners = torch.where(touched[:, None], eligible, hosts)
    return owners & live[:, None]


def sweep(
    store: MetadataStore,
    h: float,
    now: int,
    expiry: int | None = None,
    *,
    object_bytes: torch.Tensor | None = None,
    capacity_bytes=None,
    backend: str = "jax",
    avail: torch.Tensor | None = None,
) -> tuple[PlacementPlan, MetadataStore]:
    """One full-cluster analysis pass. Returns the plan and a store with the
    plan reflected (hosts and live updated, counts of expired keys
    cleared); moving the data is the caller's step 4. ``avail`` ``[N]``
    bool keeps the daemon off down nodes. ``capacity_bytes`` (``[N]`` or a
    scalar) trims the plan to per-node replica-byte budgets of
    ``object_bytes`` (``[K]``, default 1.0 a key: budgets count replicas);
    ``None`` skips the stage and an infinite budget is an identity."""
    if backend not in SWEEP_BACKENDS:
        raise ValueError(f"unknown sweep backend {backend!r}; expected one of {SWEEP_BACKENDS}")
    # Imported here: the kernel's plain version imports ``repro_torch.core``,
    # whose package module imports this one.
    from repro_torch.kernels.ownership_sweep.ops import ownership_sweep

    counts, hosts, live = store.access_counts, store.hosts, store.live
    owners, to_add, to_drop, expired, f = ownership_sweep(
        counts, hosts, live, store.last_access, now,
        h=h, expiry=expiry if _expiry_enabled(expiry) else 0,
    )
    evicted = None
    if avail is not None:
        owners = owners & avail[None, :]
    if capacity_bytes is not None:
        obj = (torch.ones(store.num_keys, dtype=torch.float32, device=counts.device)
               if object_bytes is None else object_bytes)
        owners, evicted, _ = project_capacity(owners, hosts, f, obj, capacity_bytes)
    if avail is not None or capacity_bytes is not None:
        to_add, to_drop = owners & ~hosts, hosts & ~owners
    plan = PlacementPlan(owners=owners, to_add=to_add, to_drop=to_drop, expired=expired, f=f,
                         capacity_evicted=evicted)
    new_store = store._replace(
        hosts=owners,
        live=live & ~expired,
        access_counts=torch.where(expired[:, None], torch.zeros_like(counts), counts),
    )
    return plan, new_store


def apply_plan(values_present: torch.Tensor, plan: PlacementPlan) -> torch.Tensor:
    """Enforce a plan on a ``[K, N]`` presence mask of value replicas."""
    present = values_present | plan.to_add
    return present & ~plan.to_drop & ~plan.expired[:, None]


def _decay_counts(store: MetadataStore, decay: float, *, always: bool = False) -> MetadataStore:
    """Beyond-paper exponential decay of the counts after a sweep,
    ``floor(f32(count) * decay)``; a no-op at ``decay >= 1`` unless
    ``always``. The engine's policy sweep applies it always, as the
    reference's traced decay does (exact at ``decay == 1`` below 2**24)."""
    if decay >= 1.0 and not always:
        return store
    counts = store.access_counts
    # torch.full fills on the device; torch.tensor would copy from the host
    # and synchronise the stream once per sweep.
    factor = torch.full((), decay, dtype=torch.float32, device=counts.device)
    return store._replace(access_counts=torch.floor(counts.to(torch.float32) * factor).to(torch.int32))


def _sweep_stats(plan: PlacementPlan) -> SweepStats:
    """The moves of one committed sweep."""
    evicted = plan.capacity_evicted
    return SweepStats(
        adds=plan.to_add.sum(),
        drops=plan.to_drop.sum(),
        expiry_evictions=(plan.to_drop & plan.expired[:, None]).sum(),
        capacity_evictions=(torch.zeros((), dtype=torch.int64, device=plan.owners.device)
                            if evicted is None else evicted.sum()),
    )


def _no_moves(device: torch.device) -> SweepStats:
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return SweepStats(zero, zero, zero, zero)


def masked_step(
    store: MetadataStore,
    now: int,
    due: bool,
    *,
    h: float,
    expiry: int | None = None,
    decay: float = 1.0,
    object_bytes: torch.Tensor | None = None,
    capacity_bytes=None,
    backend: str = "jax",
    avail: torch.Tensor | None = None,
) -> tuple[SweepStats, MetadataStore]:
    """One daemon tick: ``sweep`` and the count decay, committed only when
    ``due``. ``due`` is known on the host, so an off tick skips the sweep
    outright where the reference computes and masks it; the results are the
    same. Returns ``(stats, store)``, the stats all zero off a due tick."""
    if not due:
        return _no_moves(store.hosts.device), store
    plan, swept = sweep(store, h, now, expiry, object_bytes=object_bytes,
                        capacity_bytes=capacity_bytes, backend=backend, avail=avail)
    return _sweep_stats(plan), _decay_counts(swept, decay)


class PlacementDaemon:
    """Periodic offline repartitioner (paper §5.1 'Placement Daemon'):
    holds H (validated against the cluster size), the decay and expiry
    policy and the period, and runs ``sweep`` on the store it is handed."""

    def __init__(
        self,
        num_nodes: int,
        h: float | None = None,
        expiry: int | None = None,
        period: int = 1,
        decay: float = 1.0,
        backend: str = "jax",
    ) -> None:
        if h is None:
            h = 1.0 / num_nodes
        validate_coefficient(h, num_nodes)
        if not (0.0 < decay <= 1.0):
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        if expiry is not None and expiry < 0:
            raise ValueError(
                f"expiry must be None or a non-negative tick count, got "
                f"{expiry} (0 disables expiry, on every backend)"
            )
        if backend not in SWEEP_BACKENDS:
            raise ValueError(f"unknown sweep backend {backend!r}; expected one of {SWEEP_BACKENDS}")
        self.num_nodes = num_nodes
        self.h = h
        self.expiry = expiry
        self.period = period
        self.decay = decay
        self.backend = backend

    def due(self, tick: int) -> bool:
        return tick % self.period == 0

    def step(self, store: MetadataStore, now: int, *, object_bytes: torch.Tensor | None = None,
             capacity_bytes=None, avail: torch.Tensor | None = None,
             ) -> tuple[PlacementPlan, MetadataStore]:
        plan, store = sweep(store, self.h, now, self.expiry, object_bytes=object_bytes,
                            capacity_bytes=capacity_bytes, backend=self.backend, avail=avail)
        return plan, _decay_counts(store, self.decay)

    def masked_step(self, store: MetadataStore, now: int, due: bool, *,
                    object_bytes: torch.Tensor | None = None, capacity_bytes=None,
                    avail: torch.Tensor | None = None) -> tuple[SweepStats, MetadataStore]:
        """``step`` committed only when ``due``."""
        return masked_step(store, now, due, h=self.h, expiry=self.expiry, decay=self.decay,
                           object_bytes=object_bytes, capacity_bytes=capacity_bytes,
                           backend=self.backend, avail=avail)
