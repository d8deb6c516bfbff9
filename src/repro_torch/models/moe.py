"""Mixture-of-Experts FFN with the Redynis hot-expert replica path
(counterpart of ``src/repro/models/moe.py``, both of its ``moe_impl``
paths).

GShard-style capacity routing: tokens split into groups of
``cfg.moe_group_size``; each (token, top-k slot) assignment takes a
position in its expert's buffer by cumsum and is dropped past the static
capacity. With ``hot_ids`` (the placement daemon's replica set of R
experts) an assignment to a hot expert goes to a local replica buffer
instead, whose weights are gathered from the live params in the forward
pass; the cold capacity shrinks to ``cfg.moe_cold_capacity`` of its size.

The router and its ``[G, E]`` counts go through the ``moe_router`` kernel
on the card; its gates carry a gradient (``kernels/moe_router/ops.py``).
With ``moe_impl="einsum"`` the cold dispatch and combine are one-hot
matmuls; with ``"sort"`` (``sort_dispatch``, ``sort_combine``) the
(token, slot) assignments are sorted by expert and their rows scattered
into the ``[E, G, C, D]`` buffer and gathered back. The expert FFNs are
batched matmuls. All of it is left to torch ops as the reference leaves it
to XLA; the hot path is the einsum form in both modes, as there.

``moe_apply`` takes a params dict with the reference tree's keys
(``router``, ``w_gate``, ``w_up``, ``w_down``, ``shared``), so reference
weights carry across one to one (``interop.params_from_numpy``).

On a mesh (local view, see ``dist.py``): the dispatch groups are the
reference's (their size from the global token count) and split over the
batch axes; a group that spans ranks (fewer groups than batch ranks) is
gathered and computed whole on each, each rank keeping its own rows. The
routing is replicated over the model axis; the experts are split over it
(EP): each rank dispatches to and runs its own experts, and one
all-reduce over the model axis combines them with the shared experts'
TP-split output, as the reference's combine is one psum over the model
axis. Hot replicas are gathered from the split expert stacks by a masked
local gather and an all-reduce. The stats are global (``counts [G, E]``
and every scalar the same on every rank).

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

from repro_torch import dist as dist_lib
from repro_torch.dist import all_gather, all_reduce, copy_to, on_mesh
from repro_torch.kernels.moe_router.ops import moe_router
from repro_torch.models.layers import swiglu, swiglu_specs
from repro_torch.models.params import ParamSpec, dense_init

__all__ = ["MoE", "moe_specs", "moe_apply", "cold_capacity", "hot_capacity"]


def _model(dist) -> tuple:
    return (dist.model_axis,) if on_mesh(dist) and dist.model_axis is not None else ()


def row_parallel(spec: str, a: torch.Tensor, w: torch.Tensor, dist, reduce: bool = True) -> torch.Tensor:
    """``einsum(spec, a, w)`` whose contraction is split over the model axis:
    each rank's partial sum is formed in f32 (bf16 products are exact in
    it) and all-reduced in f32, then rounded once to ``a``'s dtype, as the
    one-device product rounds once. ``reduce=False`` leaves the f32 partial."""
    y = torch.einsum(spec, a.float(), w.float())
    return all_reduce(y, dist, _model(dist)).to(a.dtype) if reduce else y


def swiglu_tp(p: dict, x: torch.Tensor, dist, width: int, reduce: bool = True) -> torch.Tensor:
    """``swiglu`` whose hidden width ``width`` may be split over the model
    axis: the replicated input enters through ``copy_to`` and the down
    projection is ``row_parallel`` (its f32 partial left with
    ``reduce=False``)."""
    if p["w_up"].shape[-1] >= width:
        return swiglu(p, x)
    x = copy_to(x, dist, _model(dist))
    gate = torch.einsum("bsd,df->bsf", x, p["w_gate"])
    up = torch.einsum("bsd,df->bsf", x, p["w_up"])
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return row_parallel("bsf,fd->bsd", hidden, p["w_down"], dist, reduce)


def moe_specs(cfg, prefix: tuple = ()) -> dict:
    """``prefix`` holds ``(size, axis_name)`` pairs that stack the params."""
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    ps = tuple(s for s, _ in prefix)
    pa = tuple(a for _, a in prefix)
    specs = {
        "router": ParamSpec(ps + (d, e), pa + ("embed", "experts"), dense_init(d), torch.float32),
        "w_gate": ParamSpec(ps + (e, d, f), pa + ("experts", "embed", "expert_mlp"), dense_init(d)),
        "w_up": ParamSpec(ps + (e, d, f), pa + ("experts", "embed", "expert_mlp"), dense_init(d)),
        "w_down": ParamSpec(ps + (e, f, d), pa + ("experts", "expert_mlp", "embed"), dense_init(f)),
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


def _flat_rows(index, width: int):
    """Per-group indices ``[G, N]`` into rows of ``width`` a group, as flat
    indices into the ``[G * width]`` rows of all groups."""
    return (index + torch.arange(index.shape[0], device=index.device)[:, None] * width).reshape(-1)


def sort_dispatch(xg, idx, gates, active, e: int, capacity: int):
    """Sort-based dispatch (``moe_impl="sort"``): no ``[G, S, E, C]``
    one-hot matmuls.

    xg ``[G, S, D]``; idx, gates and active ``[G, S, K]`` (expert, gate and
    whether to route each (token, slot) assignment here). The assignments
    of a group, token-major (``s * K + j``), are stably sorted by expert
    (inactive ones last); an assignment's position in its expert is its
    rank less its expert's first rank, and past ``capacity`` it is dropped
    into the extra slot ``E * C``. Returns ``(expert_in [E, G, C, D],
    src_tok [G, S*K], dest [G, S*K], keep_gates [G, S*K])``; the combine is
    a segment sum over the same maps (``sort_combine``)."""
    g, s, k = idx.shape
    d = xg.shape[-1]
    dev = xg.device
    flat_e = torch.where(active, idx, e).reshape(g, s * k).to(torch.int64)  # inactive sorts last
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos = torch.arange(s * k, device=dev)[None, :] - starts.gather(1, sorted_e.clamp_max(e - 1))
    keep = (sorted_e < e) & (pos < capacity)
    dest = torch.where(keep, sorted_e * capacity + pos, e * capacity)  # the drop slot
    src_tok = order // k  # token of each sorted assignment
    rows = xg.gather(1, src_tok[..., None].expand(g, s * k, d))  # [G, S*K, D]
    slots = e * capacity + 1
    buf = torch.zeros((g * slots, d), dtype=xg.dtype, device=dev)
    buf = buf.index_add(0, _flat_rows(dest, slots), rows.reshape(g * s * k, d)).reshape(g, slots, d)
    expert_in = buf[:, : e * capacity].reshape(g, e, capacity, d).permute(1, 0, 2, 3)
    sorted_gates = gates.reshape(g, s * k).gather(1, order)
    keep_gates = torch.where(keep, sorted_gates, torch.zeros((), dtype=gates.dtype, device=dev))
    return expert_in, src_tok, dest, keep_gates


def sort_combine(expert_out, src_tok, dest, s: int):
    """Gather the (gate-scaled) expert outputs ``[E, G, C, D]`` back to
    token rows and sum each token's rows: ``[G, S, D]`` in the outputs'
    dtype. The reference scatter-adds the rows in sorted order, rounding
    after each add; here each token's K rows are taken in that order (a
    stable sort of ``src_tok``, where every token appears K times) and
    added one slot at a time: the same sums, and no atomics on the card."""
    e, g, c, d = expert_out.shape
    n = src_tok.shape[1]
    k = n // s
    flat = expert_out.permute(1, 0, 2, 3).reshape(g, e * c, d)
    flat = torch.cat([flat, flat.new_zeros((g, 1, d))], dim=1)
    contrib = flat.gather(1, dest[..., None].expand(g, n, d))  # [G, S*K, D]
    by_token = torch.sort(src_tok, dim=1, stable=True).indices  # token-major, sorted order within
    rows = contrib.gather(1, by_token[..., None].expand(g, n, d)).reshape(g, s, k, d)
    y = rows[:, :, 0]
    for j in range(1, k):
        y = y + rows[:, :, j]
    return y


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
    if cfg.moe_impl not in ("einsum", "sort"):
        raise ValueError(f"moe_impl={cfg.moe_impl!r}; expected 'einsum' or 'sort'")
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    mesh = on_mesh(dist)
    nb = dist.batch_size if mesh else 1  # the ranks the rows are split over
    tokens = b * s * nb
    group = min(cfg.moe_group_size, tokens)
    while tokens % group:
        group -= 1
    g_all = tokens // group
    span = nb > 1 and g_all % nb != 0  # a group spans ranks: compute all rows here
    if span:
        x = all_gather(x, 0, dist, dist.batch_axes)
    g = g_all if (span or nb == 1) else g_all // nb
    xg = x.reshape(g, group, d)
    router = p["router"]
    if router.shape[-1] < e:  # experts split over the model axis: route over all
        router = all_gather(router, router.dim() - 1, dist, _model(dist))

    logits = torch.einsum("gsd,de->gse", xg.to(torch.float32), router.to(torch.float32))
    gates, idx, counts = _top_k_gates(logits, k)  # [G, S, K], [G, E]

    # Switch-style load-balance aux: E * sum_e frac_tokens_e * mean_prob_e.
    frac_tok = counts / torch.clamp_min(counts.sum(dim=-1, keepdim=True), 1.0)
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=1)
    aux_g = (frac_tok * mean_prob).sum(dim=-1)
    if nb > 1:  # the mean over all groups: each rank adds its share
        aux = e * all_reduce(aux_g.sum() / (g_all * (nb if span else 1)), dist, dist.batch_axes)
    else:
        aux = e * aux_g.mean()

    # Experts split over the model axis (EP): this rank's block of them.
    el = p["w_gate"].shape[0]
    ep = el < e
    lo = dist_lib.coord(dist, _model(dist)) * el if ep else 0
    xr = copy_to(xg, dist, _model(dist)) if ep else xg
    gr = copy_to(gates, dist, _model(dist)) if ep else gates

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
    if cfg.moe_impl == "sort":
        expert_in, src_tok, dest, keep_gates = sort_dispatch(xr, idx, gr, ~is_hot, e, c_cold)
        expert_out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], expert_in[lo:lo + el],
                                 "egcd", "e")
        # The gate scaling on the expert side, as on the einsum path.
        slots = e * c_cold + 1
        gate_buf = keep_gates.new_zeros(g * slots, dtype=torch.float32).index_add(
            0, _flat_rows(dest, slots), keep_gates.reshape(-1).to(torch.float32))
        gate_ec = gate_buf.reshape(g, slots)[:, : e * c_cold].reshape(g, e, c_cold).permute(1, 0, 2)
        expert_out = expert_out * gate_ec[lo:lo + el, ..., None].to(expert_out.dtype)
        if ep:  # the other ranks' experts contribute zeros here; an f32 partial sum
            expert_out = expert_out.float()
            expert_out = torch.cat([expert_out.new_zeros((lo, *expert_out.shape[1:])), expert_out,
                                    expert_out.new_zeros((e - lo - el, *expert_out.shape[1:]))])
        y = sort_combine(expert_out, src_tok, dest, group)
        kept_total = (keep_gates.detach() > 0).sum().to(torch.float32)
        del expert_in, expert_out
    else:
        disp, gate_ec, kept_total = _route(idx, gr, ~is_hot, e, c_cold, xg.dtype)
        if ep:
            disp, gate_ec = disp[:, :, lo:lo + el], gate_ec[lo:lo + el]
        expert_in = torch.einsum("gsec,gsd->egcd", disp, xr)
        expert_out = _expert_ffn(p["w_gate"], p["w_up"], p["w_down"], expert_in, "egcd", "e")
        expert_out = expert_out * gate_ec[..., None].to(expert_out.dtype)
        if ep:  # an f32 partial sum over this rank's experts
            y = torch.einsum("gsec,egcd->gsd", disp.float(), expert_out.float())
        else:
            y = torch.einsum("gsec,egcd->gsd", disp, expert_out)
        del disp, expert_in, expert_out  # freed before the hot path's buffers are made
    if cfg.num_shared_experts:
        shared = swiglu_tp(p["shared"], xg, dist, cfg.d_ff * cfg.num_shared_experts, reduce=not ep)
        y = y + shared if ep else y
    if ep:  # the experts' (and the TP shared experts') f32 partial sums, rounded once
        y = all_reduce(y, dist, _model(dist)).to(xg.dtype)

    # ---- hot path: local dispatch against in-forward-gathered replicas ----
    hot_kept = torch.zeros((), dtype=torch.float32, device=x.device)
    if use_hot:
        c_hot = hot_capacity(cfg, group)
        safe_ids = hot_ids.clamp(0, e - 1).long()
        hw_gate, hw_up, hw_down = (dist_lib.vocab_rows(p[w], safe_ids, dist) if ep else p[w][safe_ids]
                                   for w in ("w_gate", "w_up", "w_down"))
        hdisp, hgate, hot_kept = _route(hot_slot, gates, is_hot, r, c_hot, xg.dtype)
        hot_in = torch.einsum("gsrc,gsd->grcd", hdisp, xg)
        hot_out = _expert_ffn(hw_gate, hw_up, hw_down, hot_in, "grcd", "r")
        hot_out = hot_out * hgate.permute(1, 0, 2)[..., None].to(hot_out.dtype)
        y = y + torch.einsum("gsrc,grcd->gsd", hdisp, hot_out)
        kept_total = kept_total + hot_kept

    if cfg.num_shared_experts and not ep:
        y = y + shared

    n_assign = torch.full((), float(g_all * group * k), dtype=torch.float32, device=x.device)
    if nb > 1 and not span:  # the global counts, as the reference's
        counts = dist_lib.all_gather(counts.detach(), 0, dist, dist.batch_axes)
        kept_total = dist_lib.all_reduce(kept_total.detach(), dist, dist.batch_axes)
        hot_kept = dist_lib.all_reduce(hot_kept.detach(), dist, dist.batch_axes)
    stats = {
        "counts": counts,
        "aux": aux,
        "dropped": 1.0 - kept_total / n_assign,
        "hot_frac": hot_kept / n_assign,
    }
    y = y.reshape(g * group // s, s, d)
    return (y.narrow(0, dist_lib.coord(dist, dist.batch_axes) * b, b) if span else y), stats


class MoE(torch.nn.Module):
    """A thin module over one MoE layer's params dict: ``forward`` is
    ``moe_apply`` on the dict ``self.params`` (the reference tree's keys)."""

    def __init__(self, cfg, params: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.params = params

    def forward(self, x: torch.Tensor, hot_ids: torch.Tensor | None = None):
        return moe_apply(self.params, x, self.cfg, None, hot_ids)
