"""Placement policies as values (counterpart of ``src/repro/core/policy.py``).

A policy is a registered ``NamedTuple`` of hyperparameters with two hooks::

    init(store, ctx)                   -> state      # () if stateless
    decide(state, store, f, now, ctx)  -> (owners, state)

``f`` is the ``[K, N]`` ownership-fraction matrix (eq. 1) and ``owners`` the
candidate replica set. A policy whose kernel already produces ``f`` sets
``supplies_fractions`` and implements ``decide_fused(state, store, now,
ctx) -> (owners, f, state)``: ``RedynisPolicy`` runs the
``ownership_sweep`` kernel there, and its ``f`` scores the capacity
projection. Every policy then goes through the same stages
(``policy_sweep``)::

    fractions -> decide -> live/expiry mask -> availability mask -> capacity projection -> plan

so expiry and the per-node replica-byte budgets apply to every policy
alike. ``split_policy`` divides a policy into a hashable static key and a
dict of its dynamic hyperparameters (``DYNAMIC_FIELDS``), read from
``ctx.params`` inside ``decide``.

Built-ins: ``redynis`` (Algorithm 3), ``static`` (the baselines local,
remote and replicated), ``topk`` (the K globally hottest keys everywhere),
``costgreedy`` (add a replica where the RTT saved per KiB moved clears a
threshold), ``decaylfu`` (Algorithm 3 on an access EMA kept as policy
state) and ``sizeaware`` (small objects everywhere, large ones on their
hottest sources). ``POLICIES`` maps names to classes; ``parse_policy``
turns specs such as ``"redynis:h=0.2,decay=0.9"`` or ``"local"`` into
instances. Labels and errors are the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.costmodel import project_capacity
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.ownership import (
    eligible_from_fractions,
    first_argmax,
    ownership_fraction,
    validate_coefficient,
)
from repro_torch.core.placement import (
    PlacementPlan,
    SweepStats,
    _no_moves,
    _sweep_stats,
    redynis_candidates,
)

__all__ = [
    "POLICIES",
    "DYNAMIC",
    "PolicyContext",
    "RedynisPolicy",
    "StaticPolicy",
    "TopKPolicy",
    "CostGreedyPolicy",
    "DecayLFUPolicy",
    "SizeAwarePolicy",
    "register_policy",
    "make_policy",
    "parse_policy",
    "split_policy",
    "describe_policy",
    "policy_repr",
    "policy_sweep",
    "policy_masked_step",
    "publish_mask",
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
    object_bytes:   ``[K]`` f32 per-key payload size.
    capacity_bytes: ``[N]`` f32 per-node replica-byte budget, or ``None``
                    when every budget is infinite (no projection stage).
    params:         this policy's dynamic hyperparameters (floats).
    avail:          ``[N]`` bool node availability this chunk under failure
                    injection, or ``None`` (no membership mask).
    """

    rtt: torch.Tensor
    object_bytes: torch.Tensor
    capacity_bytes: torch.Tensor | None
    params: dict
    avail: torch.Tensor | None = None


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 on ``like``'s device (filled there: no host copy), so a
    comparison or product is taken in f32 as the reference's traced
    scalars are."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

POLICIES: dict[str, type] = {}
_ALIASES: dict[str, tuple[str, dict]] = {
    "local": ("static", {"mode": "local"}),
    "remote": ("static", {"mode": "remote"}),
    "replicated": ("static", {"mode": "replicated"}),
}


def register_policy(cls: type) -> type:
    """Class decorator: add ``cls`` to ``POLICIES`` under ``cls.name``, and
    make equality and hashing class-aware (two families with equal field
    tuples must not compare equal as grouping keys)."""

    def __eq__(self, other):
        return type(other) is type(self) and tuple.__eq__(self, other) is True

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash((type(self).__qualname__,) + tuple(self))

    cls.__eq__ = __eq__
    cls.__ne__ = __ne__
    cls.__hash__ = __hash__
    POLICIES[cls.name] = cls
    return cls


def make_policy(name: str, **kwargs):
    """Instantiate a registered policy by name (aliases resolved)."""
    if name in _ALIASES:
        base, preset = _ALIASES[name]
        return POLICIES[base](**{**preset, **kwargs})
    if name not in POLICIES:
        known = sorted(set(POLICIES) | set(_ALIASES))
        raise ValueError(f"unknown policy {name!r}; expected one of {known}")
    return POLICIES[name](**kwargs)


def _coerce(text: str):
    low = text.lower()
    if low == "none":
        return None
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_policy(spec: str):
    """Parse a policy spec ``name[:k=v,...]``: ``"redynis"``,
    ``"redynis:h=0.2,decay=0.9"``, ``"topk:k=50"``, ``"static:mode=remote"``
    or the aliases ``"local" | "remote" | "replicated"``."""
    name, _, tail = spec.partition(":")
    kwargs = {}
    if tail:
        for item in tail.split(","):
            key, eq, value = item.partition("=")
            if not eq:
                raise ValueError(f"bad policy spec {spec!r}: expected k=v, got {item!r}")
            kwargs[key.strip()] = _coerce(value.strip())
    return make_policy(name.strip(), **kwargs)


def split_policy(policy) -> tuple:
    """``(static_key, params)``: the policy with every dynamic field set to
    ``DYNAMIC``, and a dict of those fields as floats."""
    dyn = type(policy).DYNAMIC_FIELDS
    params = {name: float(getattr(policy, name)) for name in dyn}
    return policy._replace(**{name: DYNAMIC for name in dyn}), params


def _label_fields(policy) -> list[str]:
    """``k=v`` parts of a label: the non-default fields, and any field the
    class lists in ``ALWAYS_LABEL``."""
    cls = type(policy)
    always = getattr(cls, "ALWAYS_LABEL", ())
    return [
        f"{name}={getattr(policy, name)!r}"
        for name in cls._fields
        if name in always or getattr(policy, name) != cls._field_defaults.get(name)
    ]


def describe_policy(policy) -> str:
    """Compact registry-name label: ``redynis(h=0.2)``."""
    parts = _label_fields(policy)
    return f"{type(policy).name}({', '.join(parts)})" if parts else type(policy).name


def policy_repr(policy) -> str:
    """Constructor spelling: ``RedynisPolicy(h=0.2)``."""
    return f"{type(policy).__name__}({', '.join(_label_fields(policy))})"


def _validate_common(policy, *, decay=None, period=None):
    if decay is not None and not (0.0 < decay <= 1.0):
        raise ValueError(f"{type(policy).__name__}: decay must be in (0, 1], got {decay}")
    if period is not None and period < 1:
        raise ValueError(f"{type(policy).__name__}: period must be >= 1, got {period}")


def _stable_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Dense rank along the last dim, highest score first, ties to the lower
    index (a stable argsort of ``-scores``, scattered back)."""
    order = torch.sort(-scores, dim=-1, stable=True).indices
    pos = torch.arange(scores.shape[-1], device=scores.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


# ---------------------------------------------------------------------------
# Built-in policies.
# ---------------------------------------------------------------------------


@register_policy
class RedynisPolicy(NamedTuple):
    """Paper Algorithm 3: replicate where the ownership fraction clears H.
    ``h=None`` resolves to the starvation-safe maximum ``1/n``. The engine
    decides through the ``ownership_sweep`` kernel (``decide_fused``); the
    reference engine through the plain ``decide``."""

    h: float | None = None  # ownership coefficient (eq. 2); None -> 1/n
    expiry: int = 0  # ticks before untouched keys are purged; 0 disables
    decay: float = 1.0  # post-sweep count decay (1.0 = paper's raw counters)
    period: int = 1  # sweep every `period`-th tick

    name = "redynis"
    DYNAMIC_FIELDS = ("h", "decay")
    is_active = True
    read_mode = "map"
    initial_placement = "offsite"
    supplies_fractions = True

    def resolve(self, num_nodes: int) -> "RedynisPolicy":
        return self if self.h is not None else self._replace(h=1.0 / num_nodes)

    def validate(self, num_nodes: int) -> None:
        validate_coefficient(self.h, num_nodes)
        if self.expiry < 0:
            raise ValueError(
                f"expiry must be a non-negative tick count, got {self.expiry} "
                f"(0 disables expiry)"
            )
        _validate_common(self, decay=self.decay, period=self.period)

    def init(self, store: MetadataStore, ctx: PolicyContext):
        return ()

    def decide_fused(self, state, store: MetadataStore, now: int, ctx: PolicyContext):
        # Imported per call: the kernel's plain version imports this package.
        from repro_torch.kernels.ownership_sweep.ops import ownership_sweep

        owners, _, _, _, f = ownership_sweep(
            store.access_counts, store.hosts, store.live, store.last_access, now,
            h=ctx.params["h"], expiry=self.expiry,
        )
        return owners, f, state

    def decide(self, state, store: MetadataStore, f, now: int, ctx: PolicyContext):
        return redynis_candidates(store, f, ctx.params["h"]), state


@register_policy
class StaticPolicy(NamedTuple):
    """The non-adaptive baselines (paper §9): ``mode="local"`` (the
    idealised everything-local scenario), ``"remote"`` (no local replicas;
    every op pays a WAN hop) and ``"replicated"`` (naive full replication).
    The replica map never changes, so the daemon never runs."""

    mode: str = "local"

    name = "static"
    MODES = ("local", "remote", "replicated")
    DYNAMIC_FIELDS = ()
    ALWAYS_LABEL = ("mode",)
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

    def init(self, store: MetadataStore, ctx: PolicyContext):
        return ()

    def decide(self, state, store: MetadataStore, f, now: int, ctx: PolicyContext):
        return store.hosts, state  # never called (is_active=False)


@register_policy
class TopKPolicy(NamedTuple):
    """Replicate the K globally hottest keys on every node; each cold key
    collapses to its modal request source. Untouched keys keep their
    placement."""

    k: float = 100.0  # number of globally-hottest keys to replicate
    decay: float = 1.0
    period: int = 1

    name = "topk"
    DYNAMIC_FIELDS = ("k", "decay")
    is_active = True
    read_mode = "map"
    initial_placement = "offsite"

    def resolve(self, num_nodes: int) -> "TopKPolicy":
        return self

    def validate(self, num_nodes: int) -> None:
        if self.k < 0:
            raise ValueError(f"k must be non-negative, got {self.k}")
        _validate_common(self, decay=self.decay, period=self.period)

    def init(self, store: MetadataStore, ctx: PolicyContext):
        return ()

    def decide(self, state, store: MetadataStore, f, now: int, ctx: PolicyContext):
        counts = store.access_counts
        total = counts.sum(dim=-1, dtype=torch.int32)
        # Rank compared in f32 with k, as the reference promotes it.
        ranks = _stable_ranks(total).to(torch.float32)
        touched = total > 0
        hot = (ranks < _f32(ctx.params["k"], ranks)) & touched
        n = counts.shape[1]
        modal = torch.arange(n, device=counts.device) == first_argmax(counts)[:, None]
        cold = torch.where(touched[:, None], modal, store.hosts)
        return hot[:, None] | cold, state


@register_policy
class CostGreedyPolicy(NamedTuple):
    """Size-aware greedy growth (after Didona & Zwaenepoel, 1802.00696): add
    a replica of O on x when the RTT milliseconds its traffic would save per
    KiB moved clears ``min_saved_ms_per_kib``. Saved ms = accesses from x x
    (nearest-replica RTT now - local RTT). It only grows the replica set;
    expiry and the capacity projection shrink it. Scoring takes a
    ``[K, N, N]`` intermediate (100 MB at 1 M keys x 5 nodes)."""

    min_saved_ms_per_kib: float = 100.0
    decay: float = 1.0
    period: int = 1

    name = "costgreedy"
    DYNAMIC_FIELDS = ("min_saved_ms_per_kib", "decay")
    is_active = True
    read_mode = "map"
    initial_placement = "offsite"

    def resolve(self, num_nodes: int) -> "CostGreedyPolicy":
        return self

    def validate(self, num_nodes: int) -> None:
        if self.min_saved_ms_per_kib < 0:
            raise ValueError(
                f"min_saved_ms_per_kib must be non-negative, got {self.min_saved_ms_per_kib}"
            )
        _validate_common(self, decay=self.decay, period=self.period)

    def init(self, store: MetadataStore, ctx: PolicyContext):
        return ()

    def decide(self, state, store: MetadataStore, f, now: int, ctx: PolicyContext):
        rtt, hosts = ctx.rtt, store.hosts
        # Read cost from node x now: nearest replica of the key; an empty
        # set pays the topology's worst RTT (backing-store fetch).
        inf = _f32(float("inf"), rtt)
        cost_now = torch.where(hosts[:, None, :], rtt[None, :, :], inf).amin(dim=-1)  # [K, N]
        cost_now = torch.where(torch.isfinite(cost_now), cost_now, rtt.max())
        local = torch.diagonal(rtt)
        saved_ms = store.access_counts.to(torch.float32) * torch.clamp_min(
            cost_now - local[None, :], 0.0)
        # The reference's op order: a division by the size in KiB (1024 is a
        # power of two, so the size's scaling is exact on every device).
        per_kib = saved_ms / (ctx.object_bytes[:, None] / _f32(1024.0, rtt))
        return hosts | (per_kib >= _f32(ctx.params["min_saved_ms_per_kib"], rtt)), state


@register_policy
class DecayLFUPolicy(NamedTuple):
    """Algorithm 3's eligibility rule on an exponentially-decayed access EMA
    kept in the policy's own state (the metadata counters stay raw). Each
    sweep folds the accesses since the last committed sweep,
    ``ema = alpha * ema + delta``, and replicates where the EMA fraction
    clears H."""

    h: float | None = None  # eligibility threshold on EMA fractions
    alpha: float = 0.5  # EMA retention per sweep (1.0 = raw counts)
    period: int = 1

    name = "decaylfu"
    DYNAMIC_FIELDS = ("h", "alpha")
    is_active = True
    read_mode = "map"
    initial_placement = "offsite"

    def resolve(self, num_nodes: int) -> "DecayLFUPolicy":
        return self if self.h is not None else self._replace(h=1.0 / num_nodes)

    def validate(self, num_nodes: int) -> None:
        validate_coefficient(self.h, num_nodes)
        if not (0.0 < self.alpha <= 1.0):
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        _validate_common(self, period=self.period)

    def init(self, store: MetadataStore, ctx: PolicyContext):
        ema = torch.zeros(store.access_counts.shape, dtype=torch.float32,
                          device=store.access_counts.device)
        return ema, store.access_counts.to(torch.float32)

    def decide(self, state, store: MetadataStore, f, now: int, ctx: PolicyContext):
        ema, prev = state
        counts = store.access_counts.to(torch.float32)
        # XLA contracts ``ema * alpha + (counts - prev)`` into one fused
        # multiply-add on the CPU: an f64 product and sum, rounded once.
        alpha = _f32(ctx.params["alpha"], ema).double()
        ema = (ema.double() * alpha + (counts - prev).double()).to(torch.float32)
        # f32 traffic: the left-to-right fractions, not the kernel's.
        eligible = eligible_from_fractions(ownership_fraction(ema), ema, ctx.params["h"])
        owners = torch.where((ema.sum(dim=-1) > 0)[:, None], eligible, store.hosts)
        return owners, (ema, counts)


@register_policy
class SizeAwarePolicy(NamedTuple):
    """Minos-style size-aware sharding (Didona & Zwaenepoel, 1802.00696):
    small objects (``object_bytes <= size_threshold_bytes``) replicate on
    every node once touched; a large object keeps its ``large_fanout``
    hottest request sources (its modal source always). Untouched keys keep
    their placement."""

    size_threshold_bytes: float = 4096.0  # small/large pool cut
    large_fanout: float = 2.0  # replicas kept per touched large object
    decay: float = 1.0  # post-sweep count decay (shared stage)
    period: int = 1

    name = "sizeaware"
    DYNAMIC_FIELDS = ("size_threshold_bytes", "large_fanout", "decay")
    is_active = True
    read_mode = "map"
    initial_placement = "offsite"

    def resolve(self, num_nodes: int) -> "SizeAwarePolicy":
        return self

    def validate(self, num_nodes: int) -> None:
        if self.size_threshold_bytes < 0:
            raise ValueError(
                f"size_threshold_bytes must be non-negative, got {self.size_threshold_bytes}"
            )
        if self.large_fanout < 1:
            raise ValueError(
                f"large_fanout must be >= 1 (every touched large object "
                f"keeps at least its modal source), got {self.large_fanout}"
            )
        _validate_common(self, decay=self.decay, period=self.period)

    def init(self, store: MetadataStore, ctx: PolicyContext):
        return ()

    def decide(self, state, store: MetadataStore, f, now: int, ctx: PolicyContext):
        counts = store.access_counts
        n = counts.shape[1]
        touched = counts.sum(dim=-1) > 0
        small = ctx.object_bytes <= _f32(ctx.params["size_threshold_bytes"], counts)
        ranks = _stable_ranks(counts).to(torch.float32)
        modal = torch.arange(n, device=counts.device) == first_argmax(counts)[:, None]
        narrow = ((ranks < _f32(ctx.params["large_fanout"], counts)) & (counts > 0)) | modal
        pool = small[:, None] | narrow
        return torch.where(touched[:, None], pool, store.hosts), state


# ---------------------------------------------------------------------------
# The shared engine: decide, then the same expiry and capacity stages.
# ---------------------------------------------------------------------------


def policy_sweep(
    policy, state, store: MetadataStore, now: int, ctx: PolicyContext, *, fused: bool = True
) -> tuple[PlacementPlan, object, MetadataStore]:
    """One decision pass for any policy: fractions -> ``decide`` ->
    live/expiry mask -> availability mask (``ctx.avail``) -> capacity
    projection -> plan and store update, then
    the post-sweep count decay where the policy has one. ``policy`` is a
    static key from :func:`split_policy`. ``fused=False`` takes the plain
    ``decide`` even where the policy supplies its fractions through a
    kernel (the reference engine's route). Returns ``(plan, state, store)``."""
    counts, hosts, live = store.access_counts, store.hosts, store.live
    with obs.span("decide"):
        if fused and getattr(policy, "supplies_fractions", False):
            owners, f, state = policy.decide_fused(state, store, now, ctx)
        else:
            f = ownership_fraction(counts)
            owners, state = policy.decide(state, store, f, now, ctx)

    expiry = getattr(policy, "expiry", 0)
    if expiry and expiry > 0:
        expired = live & ((int(now) - store.last_access) > expiry)
        owners = owners & (live & ~expired)[:, None]
        counts = torch.where(expired[:, None], torch.zeros_like(counts), counts)
    else:
        expired = torch.zeros_like(live)
        owners = owners & live[:, None]
    if ctx.avail is not None:
        # Down nodes take no new replica and drop the copies they hold (a
        # rejoining node resyncs); a crashed node's lost copies are re-seeded
        # on live nodes here, under the same capacity projection.
        owners = owners & ctx.avail[None, :]

    evicted = None
    if ctx.capacity_bytes is not None:
        with obs.span("capacity_projection"):
            owners, evicted, _ = project_capacity(owners, hosts, f, ctx.object_bytes,
                                                  ctx.capacity_bytes)

    plan = PlacementPlan(owners=owners, to_add=owners & ~hosts, to_drop=hosts & ~owners,
                         expired=expired, f=f, capacity_evicted=evicted)
    if "decay" in ctx.params:
        with obs.span("count_decay"):
            # floor(count * decay) is an identity at decay 1.0 below 2**24.
            counts = torch.floor(counts.to(torch.float32)
                                 * _f32(ctx.params["decay"], f)).to(torch.int32)
    return plan, state, store._replace(hosts=owners, live=live & ~expired, access_counts=counts)


def publish_mask(old_hosts: torch.Tensor, new_hosts: torch.Tensor) -> torch.Tensor:
    """``[K]`` bool: the keys whose replica row a daemon step changed, the
    versioned publish a placement commit sends the directory tier
    (``kvsim.routing``)."""
    return (old_hosts != new_hosts).any(dim=-1)


def policy_masked_step(
    policy, state, store: MetadataStore, now: int, due: bool, ctx: PolicyContext
) -> tuple[SweepStats, object, MetadataStore]:
    """One daemon tick. ``due`` is known on the host (``now % period``), so
    an off tick skips the sweep outright where the reference computes and
    masks it; the store and the policy state are committed only on a due
    tick, and an off tick's stats are zero. Returns ``(stats, state, store)``."""
    if not due:
        return _no_moves(store.hosts.device), state, store
    with obs.span("policy_step"):
        obs.count("sweeps")
        plan, state, store = policy_sweep(policy, state, store, now, ctx)
        with obs.span("sweep_stats"):
            return _sweep_stats(plan), state, store
