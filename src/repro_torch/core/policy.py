"""Placement policies as values (counterpart of ``src/repro/core/policy.py``), for
the four paper baselines: ``StaticPolicy`` with modes local, remote and
replicated, and ``RedynisPolicy`` (Algorithm 3) as "optimized".

``split_policy`` divides a policy into a hashable static key and a dict of
its dynamic hyperparameters (H, decay), as the reference does. The Redynis
decision runs through the ``ownership_sweep`` kernel, then the shared
stages: live/expiry mask, plan, and the post-sweep count decay
``floor(f32(count) * decay)``. Finite capacity budgets and the other
policies come with a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.metadata import MetadataStore
from repro_torch.core.ownership import validate_coefficient
from repro_torch.core.placement import PlacementPlan, SweepStats
from repro_torch.kernels.ownership_sweep.ops import ownership_sweep

__all__ = [
    "DYNAMIC",
    "PolicyContext",
    "RedynisPolicy",
    "StaticPolicy",
    "split_policy",
    "policy_sweep",
    "policy_masked_step",
]


class _Dynamic:
    """Placeholder a dynamic field holds on a static key; the value travels
    in ``PolicyContext.params``."""

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<dynamic>"


DYNAMIC = _Dynamic()


class PolicyContext(NamedTuple):
    """Inputs every policy step receives.

    rtt:            ``[N, N]`` pairwise RTT matrix (ms).
    object_bytes:   ``[K]`` per-key payload size.
    capacity_bytes: ``None`` (every budget infinite; finite budgets are a
                    later slice).
    params:         this policy's dynamic hyperparameters (floats).
    """

    rtt: torch.Tensor
    object_bytes: torch.Tensor
    capacity_bytes: torch.Tensor | None
    params: dict


class RedynisPolicy(NamedTuple):
    """Paper Algorithm 3: replicate where the ownership fraction clears H.
    ``h=None`` resolves to the starvation-safe maximum ``1/n``."""

    h: float | None = None  # ownership coefficient (eq. 2); None -> 1/n
    expiry: int = 0  # ticks before untouched keys are purged; 0 disables
    decay: float = 1.0  # post-sweep count decay (1.0 = paper's raw counters)
    period: int = 1  # sweep every `period`-th tick

    name = "redynis"
    DYNAMIC_FIELDS = ("h", "decay")
    is_active = True
    read_mode = "map"
    initial_placement = "offsite"

    def resolve(self, num_nodes: int) -> "RedynisPolicy":
        return self if self.h is not None else self._replace(h=1.0 / num_nodes)

    def validate(self, num_nodes: int) -> None:
        validate_coefficient(self.h, num_nodes)
        if self.expiry < 0:
            raise ValueError(
                f"expiry must be a non-negative tick count, got {self.expiry} "
                f"(0 disables expiry)"
            )
        if not (0.0 < self.decay <= 1.0):
            raise ValueError(f"RedynisPolicy: decay must be in (0, 1], got {self.decay}")
        if self.period < 1:
            raise ValueError(f"RedynisPolicy: period must be >= 1, got {self.period}")


class StaticPolicy(NamedTuple):
    """The non-adaptive baselines (paper §9): ``mode="local"`` (the
    idealised everything-local scenario), ``"remote"`` (no local replicas;
    every op pays a WAN hop) and ``"replicated"`` (naive full replication).
    The replica map never changes, so the daemon never runs."""

    mode: str = "local"

    name = "static"
    MODES = ("local", "remote", "replicated")
    DYNAMIC_FIELDS = ()
    is_active = False

    @property
    def read_mode(self) -> str:
        return {"local": "ideal", "remote": "no_local", "replicated": "map"}[self.mode]

    @property
    def initial_placement(self) -> str:
        return "offsite" if self.mode == "remote" else "full"

    def resolve(self, num_nodes: int) -> "StaticPolicy":
        return self

    def validate(self, num_nodes: int) -> None:
        if self.mode not in self.MODES:
            raise ValueError(
                f"unknown StaticPolicy mode {self.mode!r}; expected one of {self.MODES}"
            )


def split_policy(policy) -> tuple:
    """``(static_key, params)``: the policy with every dynamic field set to
    ``DYNAMIC``, and a dict of those fields as floats."""
    dyn = type(policy).DYNAMIC_FIELDS
    params = {name: float(getattr(policy, name)) for name in dyn}
    return policy._replace(**{name: DYNAMIC for name in dyn}), params


def policy_sweep(
    policy, store: MetadataStore, now: int, ctx: PolicyContext
) -> tuple[PlacementPlan, MetadataStore]:
    """One Redynis decision pass: the ``ownership_sweep`` kernel (fractions,
    eligibility with the starvation guard, silence keeps placement, expiry
    and live mask), then the store update and the count decay."""
    counts, hosts, live = store.access_counts, store.hosts, store.live
    owners, add, drop, expired, f = ownership_sweep(
        counts, hosts, live, store.last_access, now,
        h=ctx.params["h"], expiry=policy.expiry,
    )
    plan = PlacementPlan(owners=owners, to_add=add, to_drop=drop, expired=expired, f=f)
    new_counts = torch.where(expired[:, None], torch.zeros_like(counts), counts)
    # torch.full fills on the device; torch.tensor would copy from the host
    # and synchronise the stream once per sweep.
    decay = torch.full((), ctx.params["decay"], dtype=torch.float32, device=counts.device)
    # floor(count * decay) is exact at decay == 1.0 for counts below 2**24.
    new_counts = torch.floor(new_counts.to(torch.float32) * decay).to(torch.int32)
    return plan, store._replace(
        hosts=owners, live=live & ~expired, access_counts=new_counts
    )


def policy_masked_step(
    policy, state, store: MetadataStore, now: int, due: bool, ctx: PolicyContext
) -> tuple[SweepStats, object, MetadataStore]:
    """One daemon tick. ``due`` is known on the host (``now % period``), so
    an off tick skips the sweep outright where the reference masks it; the
    results are the same. Returns ``(stats, state, store)``."""
    zero = torch.zeros((), dtype=torch.int64, device=store.hosts.device)
    if not due:
        return SweepStats(zero, zero, zero, zero), state, store
    plan, store = policy_sweep(policy, store, now, ctx)
    stats = SweepStats(
        adds=plan.to_add.sum(),
        drops=plan.to_drop.sum(),
        expiry_evictions=(plan.to_drop & plan.expired[:, None]).sum(),
        capacity_evictions=zero,
    )
    return stats, state, store
