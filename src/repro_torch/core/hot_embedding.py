"""Traffic-aware hot-row embedding cache — Redynis integration #2
(counterpart of ``src/repro/core/hot_embedding.py``).

Objects are vocabulary rows, nodes are data shards, traffic is token
frequency (zipfian in natural text: the paper's skewed workload). The daemon
promotes the hottest rows with ``f >= H`` into a bounded replica cache;
``embed_with_cache`` serves each token from the cache first (the
``hot_gather`` kernel on the card) and takes the plain table lookup for the
misses. The hot table is gathered from the live table every step, so a hit
row equals the table's row bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.expert_placement import top_k_stable
from repro_torch.core.ownership import validate_coefficient
from repro_torch.device import resolve_device
from repro_torch.dist import embed_lookup, vocab_rows
from repro_torch.kernels.hot_gather.ops import hot_gather

__all__ = ["HotEmbeddingState", "HotEmbedding", "embed_with_cache"]


class HotEmbeddingState(NamedTuple):
    counts: torch.Tensor  # [V, N] f32 EMA token traffic per data shard
    hot_ids: torch.Tensor  # [R] int32 cached vocab rows (-1 = empty)
    slot_map: torch.Tensor  # [V] int32 row -> cache slot (-1 = cold)
    sweeps: torch.Tensor  # [] int32


class HotEmbedding:
    def __init__(
        self,
        vocab: int,
        num_nodes: int,
        rows: int,
        *,
        h: float | None = None,
        decay: float = 0.98,
        period: int = 50,
    ) -> None:
        if h is None or h <= 0:
            h = 1.0 / num_nodes
        validate_coefficient(h, num_nodes)
        self.v, self.n, self.r = vocab, num_nodes, rows
        self.h = h
        self.decay = decay
        self.period = period

    def init_state(self, device=None) -> HotEmbeddingState:
        """An empty cache on ``device`` (``None`` means CUDA)."""
        device = resolve_device(device)
        return HotEmbeddingState(
            counts=torch.zeros((self.v, self.n), dtype=torch.float32, device=device),
            hot_ids=torch.full((self.r,), -1, dtype=torch.int32, device=device),
            slot_map=torch.full((self.v,), -1, dtype=torch.int32, device=device),
            sweeps=torch.zeros((), dtype=torch.int32, device=device),
        )

    def fold(
        self, state: HotEmbeddingState, tokens: torch.Tensor, token_nodes: torch.Tensor
    ) -> HotEmbeddingState:
        """tokens ``[B, S]`` and token_nodes ``[B]`` (data shard of each row).

        Adds 1.0 per token, one add per event (the reference's scatter-add):
        the counts are fractional after a decay, so each add rounds, and a
        once-added per-row total would round differently. Equal addends make
        the result independent of the order of the adds (the card adds them
        with atomics)."""
        b, s = tokens.shape
        size = self.v * self.n
        idx = tokens.reshape(-1).long() * self.n + token_nodes.long().repeat_interleave(s)
        idx = torch.where((idx >= 0) & (idx < size), idx, size)  # the reference's mode="drop"
        counts = torch.cat([state.counts.reshape(-1), state.counts.new_zeros(1)])
        counts.index_add_(0, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
        return state._replace(counts=counts[:size].reshape(self.v, self.n))

    def due(self, step: int) -> bool:
        return step > 0 and step % self.period == 0

    def sweep(self, state: HotEmbeddingState) -> HotEmbeddingState:
        """Ownership test + top-R budget -> new cache contents."""
        dev = state.counts.device
        total = state.counts.sum(dim=-1)  # [V]
        f = state.counts / torch.clamp_min(total[:, None], 1.0)
        h = torch.full((), self.h, dtype=torch.float32, device=dev)
        qualify = (f >= h).any(dim=-1) & (total > 0)
        score = torch.where(qualify, total, torch.full((), -1.0, device=dev))
        top = top_k_stable(score, self.r)
        valid = score[top] > 0
        hot_ids = torch.where(valid, top, -1).to(torch.int32)
        slot_map = torch.full((self.v + 1,), -1, dtype=torch.int32, device=dev)
        slot_map[torch.where(valid, top, self.v)] = torch.arange(self.r, dtype=torch.int32, device=dev)
        slot_map = slot_map[: self.v]  # index V took the empty slots
        return HotEmbeddingState(
            counts=state.counts * self.decay,
            hot_ids=hot_ids,
            slot_map=slot_map,
            sweeps=state.sweeps + 1,
        )

    def hit_rate(self, state: HotEmbeddingState) -> torch.Tensor:
        total = state.counts.sum()
        row_total = state.counts.sum(dim=-1)
        hot = (row_total[state.hot_ids.clamp(0, self.v - 1).long()] * (state.hot_ids >= 0)).sum()
        return hot / torch.clamp_min(total, 1.0)


def embed_with_cache(
    table: torch.Tensor,  # [Vp, D]
    tokens: torch.Tensor,  # [B, S] int32
    state: HotEmbeddingState,
    dist=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level lookup. Returns ``(rows [B, S, D], hit [B, S] bool)``.

    Hot rows come from the hot table gathered from the live ``table`` this
    step, through ``hot_gather``; misses take the plain table lookup. Exact:
    a hit row equals the table's row."""
    b, s = tokens.shape
    flat = tokens.reshape(-1).to(torch.int32).contiguous()
    safe_hot = state.hot_ids.clamp(0, table.shape[0] - 1).long()
    hot_table = vocab_rows(table, safe_hot, dist)  # [R, D], fresh every step
    rows_hot, hit = hot_gather(flat, state.slot_map, hot_table)
    cold_tokens = torch.where(hit, 0, flat).reshape(b, s)
    rows_cold = embed_lookup(table, cold_tokens, dist).reshape(b * s, -1)
    rows = torch.where(hit[:, None], rows_hot.to(rows_cold.dtype), rows_cold)
    return rows.reshape(b, s, -1), hit.reshape(b, s)
