"""Replication cost model and the capacity projection (counterpart of
``src/repro/core/costmodel.py``).

Beyond the paper's threshold rule, replication is gated by a per-node
replica-byte budget: ``project_capacity`` keeps, per node, the
highest-score replicas whose cumulative size fits the node's budget (the
*capacity projection* stage of the placement pipeline). With an infinite
budget it is an identity, so Algorithm 3 is unchanged.

Admission rule, per node:

  1. rank every owned candidate by ownership fraction ``f`` descending;
     at equal ``f`` a held replica beats a new add (less churn), further
     ties broken by key id;
  2. admit candidates while the running byte total fits the node budget,
     so the hottest adds that fit are admitted and an over-budget node
     evicts its coldest held replicas;
  3. held-but-rejected replicas are capacity evictions; rejected adds never
     materialise.

Last-replica semantics: under byte pressure the projection may evict a
key's last replica; the budget outranks the eligibility layer's starvation
guard by design. Replicas are a bounded cache over a backing store, and the
simulator charges a replica-less read the topology's worst RTT (in the flat
testbed exactly ``remote_ms``, an ordinary miss).

The reference orders each node's column by three chained stable sorts and
admits by an f32 prefix sum. Here one stable sort of composite int64 keys
(node, then the reference's three keys) gives the same order (``-0.0``
ties ``0.0`` as there), and the prefix sum runs in f64 over the f32 sizes:
exact for every summation order while a node's sizes span fewer than 53
bits (1 M keys of lognormal sizes with sigma 0.5 need about 51), so the
card and the CPU admit the same keys. The reference's f32 prefix sum
rounds, and can flip ``cum <= budget`` for the one key that sits at the
budget line.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.ownership import ownership_fraction

__all__ = [
    "HardwareModel",
    "H100_SXM",
    "replication_gain",
    "project_capacity",
    "budget_plan",
]


class HardwareModel(NamedTuple):
    """Per-card hardware constants (defaults: NVIDIA H100 SXM data sheet)."""

    peak_flops: float = 989e12  # dense bf16 FLOP/s
    hbm_bw: float = 3.35e12  # device memory bytes/s
    ici_bw: float = 450e9  # link bytes/s; on this card NVLink's per-direction rate
    hbm_bytes: float = 80e9


H100_SXM = HardwareModel()


def replication_gain(
    counts: torch.Tensor,  # [K, N] traffic g(O, x)
    bytes_saved_per_access,  # float or tensor, e.g. tokens x d_model x dtype
    steps_per_sweep: float,
    object_bytes: torch.Tensor,  # [K] payload size
    hw: HardwareModel = H100_SXM,
) -> torch.Tensor:
    """Net seconds saved per sweep period by replicating O onto x, ``[K, N]``:
    remote access as a link transfer of the access payload, replication as
    a one-time link move of the object."""
    saved = counts.to(torch.float32) * bytes_saved_per_access / hw.ici_bw
    move = object_bytes.to(torch.float32)[:, None] / hw.ici_bw
    return saved * steps_per_sweep - move


def _descending_rank_bits(f: torch.Tensor) -> torch.Tensor:
    """int64 in ``[0, 2**32)`` that orders like ``-f`` (non-NaN f32), with
    ``-0.0`` equal to ``0.0``."""
    f = torch.where(f == 0, torch.zeros_like(f), f)
    bits = f.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)  # orders like f
    return (2**31 - 1) - ordered


def project_capacity(
    owners: torch.Tensor,  # [K, N] bool post-eligibility replica set
    hosts: torch.Tensor,  # [K, N] bool replica set before this sweep
    f: torch.Tensor,  # [K, N] f32 ownership fractions (the score)
    object_bytes: torch.Tensor,  # [K] f32 per-key payload size
    capacity_bytes,  # [N] tensor, sequence or scalar per-node byte budget
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trim ``owners`` to each node's byte budget. Returns ``(projected,
    evicted, rejected)``, all ``[K, N]`` bool: ``evicted`` are held
    replicas (``owners & hosts``) that no longer fit, ``rejected`` planned
    adds never admitted. An infinite budget is an identity."""
    k, n = owners.shape
    dev = owners.device
    held = owners & hosts
    budget = torch.as_tensor(capacity_bytes, dtype=torch.float32, device=dev)
    budget = budget.expand(n).to(torch.float64)
    # One sort of every node's column, node-major ([N, K] flattened: a 1-D
    # sort, which the card runs as one radix sort). Within a node, most
    # significant first: owned candidates, then f descending, then held
    # before add; the stable sort keeps key ids ascending within a tie.
    node = torch.arange(n, dtype=torch.int64, device=dev)[:, None]
    key = (node << 35) | ((~owners.t()).to(torch.int64) << 33) \
        | (_descending_rank_bits(f.t().to(torch.float32)) << 1) | (~held.t()).to(torch.int64)
    perm = torch.sort(key.reshape(-1), stable=True).indices  # [N * K], node-major
    owned_sorted = owners.t().reshape(-1)[perm]
    obj = object_bytes.to(torch.float32).to(torch.float64)
    size_sorted = torch.where(owned_sorted, obj[perm % k],
                              torch.zeros((), dtype=torch.float64, device=dev)).view(n, k)
    # A prefix sum a node, each over one contiguous row: the card scans a
    # 1-D tensor in parallel, but runs a scan along the key axis of a
    # [K, N] tensor one thread a column.
    cum = torch.empty_like(size_sorted)
    for j in range(n):
        torch.cumsum(size_sorted[j], 0, out=cum[j])
    admit_sorted = owned_sorted & (cum <= budget[:, None]).view(-1)
    admit = torch.empty_like(admit_sorted).scatter_(0, perm, admit_sorted).view(n, k).t()
    return owners & admit, held & ~admit, (owners & ~hosts) & ~admit


def budget_plan(plan, counts: torch.Tensor, object_bytes: torch.Tensor, node_budget_bytes):
    """Project a ``PlacementPlan`` onto per-node replica-byte budgets,
    scored by the ownership fractions of ``counts``: the hottest candidates
    are kept first, an over-budget node's coldest held replicas are evicted
    (``to_drop`` grows, ``capacity_evicted`` records them). An infinite
    scalar budget returns the plan unchanged."""
    if isinstance(node_budget_bytes, (int, float)) and math.isinf(node_budget_bytes):
        return plan
    f = ownership_fraction(counts)
    hosts = (plan.owners & ~plan.to_add) | plan.to_drop  # pre-sweep replica set
    projected, evicted, _ = project_capacity(plan.owners, hosts, f, object_bytes, node_budget_bytes)
    return plan._replace(
        owners=projected,
        to_add=projected & ~hosts,
        to_drop=hosts & ~projected,
        capacity_evicted=evicted,
    )
