"""Mixture-of-Experts FFN with the Redynis hot-expert replica path
(counterpart of ``src/repro/models/moe.py``, its ``moe_impl="einsum"``
path).

GShard-style capacity routing: tokens split into groups of
``cfg.moe_group_size``; each (token, top-k slot) assignment takes a
position in its expert's buffer by cumsum and is dropped past the static
capacity. With ``hot_ids`` (the placement daemon's replica set of R
experts) an assignment to a hot expert goes to a local replica buffer
instead, whose weights are gathered from the live params in the forward
pass; the cold capacity shrinks to ``cfg.moe_cold_capacity`` of its size.

The router and its ``[G, E]`` counts go through the ``moe_router`` kernel
on the card. Dispatch, combine and the expert FFNs are one-hot and batched
matmuls, left to ``torch.einsum`` as the reference leaves them to XLA.

``moe_apply`` takes a params dict with the reference tree's keys
(``router``, ``w_gate``, ``w_up``, ``w_down``, ``shared``), so reference
weights carry across one to one (``interop.params_from_numpy``).

Emitted stats (the Redynis traffic feed):
  counts  [G, E] — tokens each group routed to each expert
  aux     []     — switch-style load-balance loss
  dropped []     — fraction of (token, slot) assignments dropped
  hot_frac []    — fraction of assignments served by the replica cache
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import check_local
from repro_torch.kernels.moe_router.ops import moe_router
from repro_torch.models.layers import swiglu, swiglu_specs
from repro_torch.models.params import ParamSpec, dense_init

__all__ = ["MoE", "moe_specs", "moe_apply", "cold_capacity", "hot_capacity"]


def moe_specs(cfg, prefix: tuple = ()) -> dict:
    """``prefix`` holds ``(size, axis_name)`` pairs, as the reference's does;
    only the sizes are used."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    ps = tuple(s for s, _ in prefix)
    specs = {
        "router": ParamSpec(ps + (d, e), dense_init(d), torch.float32),
        "w_gate": ParamSpec(ps + (e, d, f), dense_init(d)),
        "w_up": ParamSpec(ps + (e, d, f), dense_init(d)),
        "w_down": ParamSpec(ps + (e, f, d), dense_init(f)),
    }
    if cfg.num_shared_experts:
        specs["shared"] = swiglu_specs(d, f * cfg.num_shared_experts, prefix)
    return specs


def _round4(x: int) -> int:
    return max(4, 4 * math.ceil(x / 4))


def cold_capacity(cfg, group: int) -> int:
    """Static per-expert capacity of the cold path."""
    scale = cfg.moe_cold_capacity if cfg.hot_expert_slots else 1.0
    return _round4(
        math.ceil(group * cfg.top_k / cfg.num_experts * cfg.moe_capacity_factor * scale)
    )


def hot_capacity(cfg, group: int) -> int:
    """Static per-replica-slot capacity of the local (hot) path."""
    return _round4(math.ceil(group * cfg.top_k * cfg.moe_hot_capacity / cfg.hot_expert_slots))


def _top_k_gates(logits: torch.Tensor, k: int):
    """softmax -> top-k -> renormalised gates, and the per-group expert
    counts. logits ``[G, S, E]`` f32 -> gates ``[G, S, K]`` f32, ids
    ``[G, S, K]`` int32, counts ``[G, E]`` f32 (one ``moe_router`` launch)."""
    g, s, e = logits.shape
    gates, ids, counts = moe_router(logits.reshape(g * s, e).contiguous(), k=k, group=s)
    return gates.reshape(g, s, k), ids.reshape(g, s, k), counts


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot that, like ``jax.nn.one_hot``, is all zeros for an index
    outside ``[0, n)``."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _dispatch_combine(idx, gate, active, prior, n_targets: int, capacity: int, dtype):
    """One GShard dispatch slot: position in target by cumsum, capacity mask.

    idx ``[G, S]`` target per token for one top-k slot, active ``[G, S]``
    bool, prior ``[G, E']`` tokens already placed per target. Returns
    ``(dispatch [G, S, E', C]`` in ``dtype``, ``gate_ec [E', G, C]`` f32 —
    this slot's gate at each filled buffer position — ``new_prior, kept
    [G, S])``. The reference also forms a ``[G, S, E', C]`` combine tensor
    that its einsum path never reads; the gate scaling is done on the expert
    side from ``gate_ec`` instead, as there."""
    oh = _one_hot(idx, n_targets) * active[..., None]
    pos = torch.cumsum(oh, dim=1) - oh + prior[:, None, :]  # [G, S, E']
    pos_tok = (pos * oh).sum(dim=-1).to(torch.int32)  # [G, S]
    keep = active & (pos_tok < capacity)
    disp = (oh * keep[..., None])[..., None] * _one_hot(pos_tok, capacity)[..., None, :]
    # Each buffer position holds at most one token, so this sum has one
    # non-zero term: exact in any order.
    gate_ec = (disp * gate.to(torch.float32)[..., None, None]).sum(dim=1).permute(1, 0, 2)
    return disp.to(dtype), gate_ec, prior + oh.sum(dim=1), keep


def _expert_ffn(w_gate, w_up, w_down, x, spec: str, e: str) -> torch.Tensor:
    """Batched swiglu over an explicit expert layout.

    spec 'egcd', e 'e' — cold path: x [E, G, C, D], weights [E, D, F]
    spec 'grcd', e 'r' — hot path:  x [G, R, C, D], weights [R, D, F]
    """
    up_spec = f"{spec},{e}df->{spec[:-1]}f"
    down_spec = f"{spec[:-1]}f,{e}fd->{spec}"
    g = torch.einsum(up_spec, x, w_gate)
    u = torch.einsum(up_spec, x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum(down_spec, h, w_down)


def _route(idx, gates, active, n_targets: int, capacity: int, dtype):
    """All k slots of one path: the summed dispatch ``[G, S, E', C]``, the
    gate of each buffer position ``[E', G, C]`` f32, and the kept count."""
    g, s, k = idx.shape
    disp = torch.zeros((g, s, n_targets, capacity), dtype=dtype, device=idx.device)
    gate_ec = torch.zeros((n_targets, g, capacity), dtype=torch.float32, device=idx.device)
    prior = torch.zeros((g, n_targets), dtype=torch.float32, device=idx.device)
    kept_total = torch.zeros((), dtype=torch.float32, device=idx.device)
    for j in range(k):
        dj, gj, prior, kept = _dispatch_combine(
            idx[..., j], gates[..., j], active[..., j], prior, n_targets, capacity, dtype
        )
        disp = disp + dj
        gate_ec = gate_ec + gj
        kept_total = kept_total + kept.sum()
    return disp, gate_ec, kept_total


def moe_apply(p: dict, x: torch.Tensor, cfg, dist=None, hot_ids: torch.Tensor | None = None):
    """MoE FFN. x ``[B, S, D]``; hot_ids ``[R]`` int32 expert ids in the
    replica cache (-1 empty). Returns ``(y [B, S, D], stats)``."""
    check_local(dist)
    if cfg.moe_impl != "einsum":
        raise NotImplementedError(f"moe_impl={cfg.moe_impl!r} is not ported yet; use 'einsum'")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    tokens = b * s
    group = min(cfg.moe_group_size, tokens)
    while tokens % group:
        group -= 1
    g = tokens // group
    xg = x.reshape(g, group, d)

    logits = torch.einsum("gsd,de->gse", xg.to(torch.float32), p["router"].to(torch.float32))
    gates, idx, counts = _top_k_gates(logits, k)  # [G, S, K], [G, E]

    # Switch-style load-balance aux: E * sum_e frac_tokens_e * mean_prob_e.
    frac_tok = counts / torch.clamp_min(counts.sum(dim=-1, keepdim=True), 1.0)
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=1)
    aux = e * (frac_tok * mean_prob).sum(dim=-1).mean()

    use_hot = hot_ids is not None and cfg.hot_expert_slots > 0
    r = cfg.hot_expert_slots if use_hot else 0
    if use_hot:
        # Which assignments hit the replica cache, and which slot (the first
        # match, as jnp.argmax picks).
        hit = idx[..., None] == hot_ids.to(idx.dtype)  # [G, S, K, R]
        is_hot = hit.any(dim=-1) & (idx >= 0)
        hot_slot = hit.to(torch.int8).argmax(dim=-1)
    else:
        is_hot = torch.zeros(idx.shape, dtype=torch.bool, device=x.device)

    # ---- cold path: capacity dispatch over all experts ----
    c_cold = cold_capacity(cfg, group)
    disp, gate_ec, kept_total = _route(idx, gates, ~is_hot, e, c_cold, xg.dtype)
    expert_in = torch.einsum("gsec,gsd->egcd", disp, xg)
    expert_out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], expert_in, "egcd", "e")
    expert_out = expert_out * gate_ec[..., None].to(expert_out.dtype)
    y = torch.einsum("gsec,egcd->gsd", disp, expert_out)
    del disp, expert_in, expert_out  # freed before the hot path's buffers are made

    # ---- hot path: local dispatch against in-forward-gathered replicas ----
    hot_kept = torch.zeros((), dtype=torch.float32, device=x.device)
    if use_hot:
        c_hot = hot_capacity(cfg, group)
        safe_ids = hot_ids.clamp(0, e - 1).long()
        hw_gate, hw_up, hw_down = (p[w][safe_ids] for w in ("w_gate", "w_up", "w_down"))
        hdisp, hgate, hot_kept = _route(hot_slot, gates, is_hot, r, c_hot, xg.dtype)
        hot_in = torch.einsum("gsrc,gsd->grcd", hdisp, xg)
        hot_out = _expert_ffn(hw_gate, hw_up, hw_down, hot_in, "grcd", "r")
        hot_out = hot_out * hgate.permute(1, 0, 2)[..., None].to(hot_out.dtype)
        y = y + torch.einsum("gsrc,grcd->gsd", hdisp, hot_out)
        kept_total = kept_total + hot_kept

    if cfg.num_shared_experts:
        y = y + swiglu(p["shared"], xg)

    n_assign = torch.full((), float(g * group * k), dtype=torch.float32, device=x.device)
    stats = {
        "counts": counts,
        "aux": aux,
        "dropped": 1.0 - kept_total / n_assign,
        "hot_frac": hot_kept / n_assign,
    }
    return y.reshape(b, s, d), stats


class MoE(torch.nn.Module):
    """A thin module over one MoE layer's params dict: ``forward`` is
    ``moe_apply`` on the dict ``self.params`` (the reference tree's keys)."""

    def __init__(self, cfg, params: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.params = params

    def forward(self, x: torch.Tensor, hot_ids: torch.Tensor | None = None):
        return moe_apply(self.params, x, self.cfg, None, hot_ids)
