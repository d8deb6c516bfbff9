"""Traffic-aware MoE expert placement — Redynis integration #1 (counterpart
of ``src/repro/core/expert_placement.py``).

Objects are (layer, expert) pairs, nodes are expert-parallel ranks, traffic
is the per-layer routing histogram ``moe_apply`` emits every step. The
daemon folds the counts into ``[L, E, N]`` EMA traffic, sweeps with the
ownership coefficient (the ``ownership_sweep`` kernel on the card, its plain
version on the CPU), budgets R replica slots per layer to the hottest
qualifying experts, and emits ``hot_ids [L, R]``, which ``moe_apply``
consumes at the next step.

Orders and ties follow the reference: the top R is a stable descending
sort, so equal scores keep the lower expert id first, as ``jax.lax.top_k``
does; the replica set's order decides ``moved``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ownership import validate_coefficient
from repro_torch.device import resolve_device
from repro_torch.kernels.ownership_sweep.ops import ownership_sweep

__all__ = ["ExpertPlacementState", "ExpertPlacement", "top_k_stable"]


class ExpertPlacementState(NamedTuple):
    counts: torch.Tensor  # [L, E, N] f32 EMA traffic g((l, e), n)
    hot_ids: torch.Tensor  # [L, R] int32 current replica sets (-1 = empty slot)
    step: torch.Tensor  # [] int32 steps folded since start
    sweeps: torch.Tensor  # [] int32 sweeps performed
    moved: torch.Tensor  # [] f32 replica slots changed by the last sweep


def top_k_stable(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last axis, ties in
    ascending index order (``jax.lax.top_k``'s order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


class ExpertPlacement:
    """The placement daemon: host-side control over device tensors."""

    def __init__(
        self,
        num_layers: int,
        num_experts: int,
        num_nodes: int,
        slots: int,
        *,
        h: float | None = None,
        decay: float = 0.98,
        period: int = 50,
    ) -> None:
        if h is None or h <= 0:
            h = 1.0 / num_nodes
        validate_coefficient(h, num_nodes)
        self.l, self.e, self.n = num_layers, num_experts, num_nodes
        self.r = slots
        self.h = h
        self.decay = decay
        self.period = period

    def init_state(self, device=None) -> ExpertPlacementState:
        """Warm set: experts ``0..R-1`` on every layer, so the reduced cold
        capacity is never starved before the first sweep. ``device=None``
        means CUDA."""
        device = resolve_device(device)
        hot = torch.arange(self.r, dtype=torch.int32, device=device).expand(self.l, self.r)
        zero_i = torch.zeros((), dtype=torch.int32, device=device)
        return ExpertPlacementState(
            counts=torch.zeros((self.l, self.e, self.n), dtype=torch.float32, device=device),
            hot_ids=hot.contiguous(),
            step=zero_i,
            sweeps=zero_i.clone(),
            moved=torch.zeros((), dtype=torch.float32, device=device),
        )

    def fold(
        self, state: ExpertPlacementState, layer_counts: torch.Tensor, group_nodes: torch.Tensor
    ) -> ExpertPlacementState:
        """layer_counts ``[L, G, E]`` from the model; group_nodes ``[G]`` maps
        dispatch groups to ranks. The per-rank sums are of whole counts, so
        exact in any order."""
        delta = torch.zeros((self.l, self.n, self.e), dtype=torch.float32, device=layer_counts.device)
        delta.index_add_(1, group_nodes.long(), layer_counts.to(torch.float32))
        return state._replace(counts=state.counts + delta.transpose(1, 2), step=state.step + 1)

    def due(self, step: int) -> bool:
        return step > 0 and step % self.period == 0

    def sweep(self, state: ExpertPlacementState) -> ExpertPlacementState:
        """Algorithm 3 over the ``[L·E, N]`` traffic + the R-slot budget."""
        l, e, n, r = self.l, self.e, self.n, self.r
        dev = state.counts.device
        flat = state.counts.reshape(l * e, n).contiguous()
        owners = ownership_sweep(
            flat,
            torch.zeros((l * e, n), dtype=torch.bool, device=dev),
            torch.ones(l * e, dtype=torch.bool, device=dev),
            torch.zeros(l * e, dtype=torch.int32, device=dev),
            0,
            h=self.h,
        )[0]
        # An expert wants replicas where it qualifies; R slots per layer go
        # to the hottest (by total traffic) first.
        qualify = owners.any(dim=-1).reshape(l, e)
        total = state.counts.sum(dim=-1)  # [L, E]
        score = torch.where(qualify & (total > 0), total, torch.full((), -1.0, device=dev))
        top = top_k_stable(score, r)  # [L, R]
        valid = score.gather(-1, top) > 0
        new_hot = torch.where(valid, top, -1).to(torch.int32)
        # Layers with no traffic at all keep their set (no churn on silence).
        layer_touched = total.sum(dim=-1, keepdim=True) > 0
        new_hot = torch.where(layer_touched, new_hot, state.hot_ids)
        moved = (new_hot[:, :, None] != state.hot_ids[:, None, :]).all(dim=-1).sum()
        return ExpertPlacementState(
            counts=state.counts * self.decay,
            hot_ids=new_hot,
            step=state.step,
            sweeps=state.sweeps + 1,
            moved=moved.to(torch.float32),
        )

    def hit_rate(self, state: ExpertPlacementState) -> torch.Tensor:
        """Fraction of (EMA) traffic the current replica sets would serve."""
        total = state.counts.sum(dim=(-1, -2))  # [L]
        safe_ids = state.hot_ids.clamp(0, self.e - 1).long()
        per_layer = state.counts.sum(dim=-1)  # [L, E]
        hot_traffic = (per_layer.gather(-1, safe_ids) * (state.hot_ids >= 0)).sum(dim=-1)
        return hot_traffic.sum() / torch.clamp_min(total.sum(), 1.0)
