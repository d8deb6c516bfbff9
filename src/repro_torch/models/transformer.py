"""Decoder-only transformer blocks, dense or MoE FFN, GQA (counterpart of
``src/repro/models/transformer.py``), in three run modes:

  * train   — full-sequence attention through ``blockwise_attention`` in
    torch ops under autograd, as the reference trains; no cache. With
    ``cfg.remat == "full"`` each layer's body runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so its
    kernels run again in the backward pass.
  * prefill — full-sequence attention through the ``flash_attention``
    kernel (where the reference calls ``blockwise_attention``); returns the
    per-layer KV cache.
  * decode  — one new token per sequence against the cache through the
    ``flash_decode`` kernel (where the reference calls
    ``decode_attention``).

Parameters are declared once with a leading ``layers`` dim
(``stacked_block_specs``) and the reference's ``lax.scan`` over layers is a
Python loop over ``torch.unbind`` views of each stacked leaf, taken once a
call, so that autograd gives each leaf one stacked gradient. Unlike the
reference's immutable arrays, the decode step writes each layer's new k/v
row into the ``[L, B, T, KH, Dh]`` cache in place. The reference's
``.at[].set`` drops a write whose slot is past the cache (``slot == T``
once an idle lane's length outgrows it); here that row writes back the
value already there, which is the same result without a host sync.

Serving attention never takes ``blockwise_attention``: ``attn_full``
and ``cross_attn`` without a ``chunk`` (prefill, the Whisper encoder and
its cross attention) run ``flash_attention`` over several queries, and
every one-query attention (``attn_decode``, the decoder's cross attention
at decode) runs ``flash_decode``. The reference passes ``cfg.attn_chunk``
at every call site; the port passes a chunk only where it trains (this
module's train mode, and the ``train=True`` forwards of ``rglru`` and
``encdec``). int8 params (``repro_torch.quant``) are dequantized one layer
at a time in ``run_decode_step``, as the reference does in its scan body.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from repro_torch import dist as dist_lib
from repro_torch.dist import all_reduce, copy_to, on_mesh
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import NEG_INF, blockwise_attention
from repro_torch.models.layers import (apply_norm, gelu_mlp, gelu_mlp_specs, norm_specs, rope,
                                       swiglu_specs)
from repro_torch.models.params import ParamSpec, dense_init, ones_init
from repro_torch.quant import dequant_tree

__all__ = [
    "KVCache",
    "init_cache_specs",
    "attn_specs",
    "mlp_specs",
    "stacked_block_specs",
    "attn_full",
    "cross_attn",
    "cross_attn_kv",
    "attn_decode",
    "mlp_apply",
    "run_decoder",
    "run_decode_step",
]


class KVCache(NamedTuple):
    """Per-layer KV cache. ``k``/``v``: [L, B, T, KH, Dh]; length: [B]."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # [B] int32 — valid entries per sequence

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def init_cache_specs(cfg, batch: int, cache_len: int, layers: int | None = None) -> KVCache:
    """The cache's shapes and dtypes as ``meta`` tensors (the dry run;
    ``Model.init_state`` makes the zeroed cache)."""
    kh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    l = cfg.num_layers if layers is None else layers
    shape = (l, batch, cache_len, kh, dh)
    return KVCache(
        k=torch.empty(shape, dtype=torch.bfloat16, device="meta"),
        v=torch.empty(shape, dtype=torch.bfloat16, device="meta"),
        length=torch.empty((batch,), dtype=torch.int32, device="meta"),
    )


# ---------------------------------------------------------------------------
# Parameter declarations


def attn_specs(cfg, prefix: tuple) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ps = tuple(s for s, _ in prefix)
    pa = tuple(a for _, a in prefix)
    specs = {
        "ln": norm_specs(d, cfg.norm, prefix),
        "wq": ParamSpec(ps + (d, h, dh), pa + ("embed", "heads", "head_dim"), dense_init(d)),
        "wk": ParamSpec(ps + (d, kh, dh), pa + ("embed", "kv_heads", "head_dim"), dense_init(d)),
        "wv": ParamSpec(ps + (d, kh, dh), pa + ("embed", "kv_heads", "head_dim"), dense_init(d)),
        "wo": ParamSpec(ps + (h, dh, d), pa + ("heads", "head_dim", "embed"), dense_init(h * dh)),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec(ps + (dh,), pa + (None,), ones_init, torch.float32)
        specs["k_norm"] = ParamSpec(ps + (dh,), pa + (None,), ones_init, torch.float32)
    return specs


def mlp_specs(cfg, prefix: tuple) -> dict:
    specs = {"ln": norm_specs(cfg.d_model, cfg.norm, prefix)}
    if cfg.num_experts:
        specs.update(moe_lib.moe_specs(cfg, prefix))
    elif cfg.act == "gelu":
        specs.update(gelu_mlp_specs(cfg.d_model, cfg.d_ff, prefix))
    else:
        specs.update(swiglu_specs(cfg.d_model, cfg.d_ff, prefix))
    return specs


def stacked_block_specs(cfg, layers: int | None = None) -> dict:
    l = cfg.num_layers if layers is None else layers
    prefix = ((l, "layers"),)
    return {"attn": attn_specs(cfg, prefix), "mlp": mlp_specs(cfg, prefix)}


def _unstack(blocks: dict, layers: int) -> list[dict]:
    """Every layer's params, each stacked leaf ``torch.unbind`` once: under
    autograd a leaf then gets one ``[L, ...]`` gradient, not ``L``
    zero-filled full-size ones (one a ``val[i]``)."""
    per = [{} for _ in range(layers)]
    for key, val in blocks.items():
        parts = _unstack(val, layers) if isinstance(val, dict) else torch.unbind(val)
        for i in range(layers):
            per[i][key] = parts[i]
    return per


# ---------------------------------------------------------------------------
# Attention block application


def _rmsnorm_head(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """qwen3-style per-head q/k RMSNorm over head_dim."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _model(dist) -> tuple:
    """The model axis as a tuple of axes (empty off a mesh)."""
    return (dist.model_axis,) if on_mesh(dist) and dist.model_axis is not None else ()


def _heads_split(p: dict, cfg) -> bool:
    """Whether this rank holds a block of the query heads (the params'
    heads dim is split over the model axis)."""
    return p["wq"].shape[-2] < cfg.num_heads


def _own_kv(t: torch.Tensor, p: dict, cfg, dist) -> torch.Tensor:
    """The kv heads ``[..., KH, Dh]`` (kv heads whole) that this rank's
    query heads read: with ``hl`` query heads a rank and ``g`` query heads
    a kv head, rank ``r`` reads kv heads from ``r * hl // g``."""
    hl, g = p["wq"].shape[-2], cfg.num_heads // cfg.num_kv_heads
    if not _heads_split(p, cfg) or t.shape[-2] < cfg.num_kv_heads:
        return t
    r = dist_lib.coord(dist, _model(dist))
    return t.narrow(-2, r * hl // g, max(hl // g, 1))


def _project_qkv(p: dict, xn: torch.Tensor, cfg, dist=None):
    """q, k, v ``[B, S, heads, Dh]``. On a mesh with the query heads split,
    ``xn`` and whole kv weights enter rank-specific work (``copy_to``);
    k and v keep every kv head the params hold (``_own_kv`` picks a
    rank's)."""
    wk, wv = p["wk"], p["wv"]
    if _heads_split(p, cfg):
        xn = copy_to(xn, dist, _model(dist))
        if wk.shape[-2] == cfg.num_kv_heads:
            wk, wv = copy_to(wk, dist, _model(dist)), copy_to(wv, dist, _model(dist))
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xn, wk)
    v = torch.einsum("bsd,dhk->bshk", xn, wv)
    if cfg.qk_norm:
        qn, kn = p["q_norm"], p["k_norm"]
        if _heads_split(p, cfg):  # whole params on this rank's heads
            qn, kn = copy_to(qn, dist, _model(dist)), copy_to(kn, dist, _model(dist))
        q = _rmsnorm_head(qn, q)
        k = _rmsnorm_head(kn, k)
    return q, k, v


def _out_proj(o: torch.Tensor, p: dict, cfg, dist, spec: str) -> torch.Tensor:
    """``o @ wo``; a rank's heads give a partial sum, formed and all-reduced
    over the model axis in f32 and rounded once (``moe.row_parallel``)."""
    if not _heads_split(p, cfg):
        return torch.einsum(spec, o, p["wo"])
    return moe_lib.row_parallel(spec, o, p["wo"], dist)


def attn_full(
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    cfg,
    dist,
    positions: torch.Tensor,  # [S]
    window: int = 0,
    chunk: int | None = None,
    causal: bool = True,
):
    """Full-sequence self-attention. Returns ``(y, (k, v))``. With
    ``chunk`` (training) through ``blockwise_attention`` in blocks of
    ``chunk``, as the reference; without (prefill, encoding) through the
    ``flash_attention`` kernel. On a mesh with the heads split (the
    reference's q constraint, heads over model) each rank attends with its
    own heads, and ``k, v`` hold the kv heads the params hold."""
    xn = apply_norm(p["ln"], x, cfg.norm)
    q, k, v = _project_qkv(p, xn, cfg, dist)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    ka, va = _own_kv(k, p, cfg, dist), _own_kv(v, p, cfg, dist)
    if chunk is not None:
        o = blockwise_attention(q, ka, va, causal=causal, window=window, chunk=chunk)
    else:
        o = flash_attention(q.contiguous(), ka.contiguous(), va.contiguous(), causal=causal,
                            window=window)
    return x + _out_proj(o, p, cfg, dist, "bshk,hkd->bsd"), (k, v)


def cross_attn(
    p: dict,
    x: torch.Tensor,  # [B, S, D] decoder side
    memory_kv: tuple,  # precomputed (k, v) [B, F, KH, Dh]
    cfg,
    dist,
    chunk: int | None = None,
) -> torch.Tensor:
    """Encoder-decoder cross attention against precomputed memory K/V,
    non-causal. With ``chunk`` (training) through ``blockwise_attention``
    in blocks of ``chunk``, as the reference, which pads and masks a memory
    that ``chunk`` does not divide. Without (serving), one query a sequence
    (decode) goes through ``flash_decode`` with every memory position valid
    (the function the reference's blockwise pass computes at S = 1),
    several through ``flash_attention``."""
    xn = apply_norm(p["ln"], x, cfg.norm)
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    k, v = memory_kv
    if chunk is not None:
        o = blockwise_attention(q, k, v, causal=False, chunk=chunk)
    elif q.shape[1] == 1:
        full = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
        o = flash_decode(q[:, 0].contiguous(), k.contiguous(), v.contiguous(), full)[:, None]
    else:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=False)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return x + y


def cross_attn_kv(p: dict, memory: torch.Tensor, cfg) -> tuple:
    """Project the encoder output once into cross-attention K/V."""
    k = torch.einsum("bfd,dhk->bfhk", memory, p["wk"])
    v = torch.einsum("bfd,dhk->bfhk", memory, p["wv"])
    return k, v


def _decode_slot(length: torch.Tensor, t: int, window: int):
    """The new token's position, its cache slot and the valid length after
    the write (the reference's ``pos``, ``slot`` and ``valid``)."""
    pos = length.to(torch.int32)
    slot = pos % t if window else pos
    valid = torch.clamp_max(length + 1, t) if window else length + 1
    return pos, slot, valid.to(torch.int32)


def _write_row(cache: torch.Tensor, slot: torch.Tensor, row: torch.Tensor) -> None:
    """``cache[b, slot[b]] = row[b]`` in place for ``cache [B, T, KH, Dh]``;
    a row whose slot is past the cache writes back what is there (the
    reference drops it)."""
    t = cache.shape[1]
    bi = torch.arange(cache.shape[0], device=cache.device)
    safe = torch.clamp_max(slot, t - 1).long()
    keep = (slot >= t)[:, None, None]
    cache[bi, safe] = torch.where(keep, cache[bi, safe], row.to(cache.dtype))


def attn_decode(
    p: dict,
    x: torch.Tensor,  # [B, D] — one token per sequence
    k_cache: torch.Tensor,  # [B, T, KH, Dh], written in place
    v_cache: torch.Tensor,
    length: torch.Tensor,  # [B] — cache entries BEFORE this token
    cfg,
    dist,
    window: int = 0,
):
    """One decode step of one layer. Returns ``(y, (k_cache, v_cache))``.

    On a mesh the cache is laid out as ``state_shardings`` lays it out:
    kv heads over the model axis where they divide it (each rank decodes
    its own heads through ``flash_decode``), else the sequence over the
    model axis (``seq_split``): the rank that holds the new token's slot
    writes it, each rank attends over its block of positions and the
    partial softmaxes combine by all-reduces (``_split_decode``)."""
    xn = apply_norm(p["ln"], x[:, None, :], cfg.norm)
    q, k, v = _project_qkv(p, xn, cfg, dist)
    t = k_cache.shape[1]
    split = seq_split(cfg, dist)
    lo = dist_lib.coord(dist, _model(dist)) * t if split else 0
    pos, slot, valid = _decode_slot(length, t * (dist.model_size if split else 1), window)
    if cfg.pos == "rope":
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    if split:  # a slot in another rank's block is past this one: no write
        slot = torch.where((slot >= lo) & (slot < lo + t), slot - lo, t)
    _write_row(k_cache, slot, k[:, 0])
    _write_row(v_cache, slot, v[:, 0])
    if split:
        qa = dist_lib.all_gather(q[:, 0], 1, dist, _model(dist)) if _heads_split(p, cfg) else q[:, 0]
        o = _split_decode(qa, k_cache, v_cache, torch.clamp(valid - lo, 0, t), dist)
        if _heads_split(p, cfg):
            o = dist_lib.own_block(o, 1, dist, _model(dist))
    else:
        o = flash_decode(q[:, 0].contiguous(), _own_kv(k_cache, p, cfg, dist),
                         _own_kv(v_cache, p, cfg, dist), valid)
    return x + _out_proj(o, p, cfg, dist, "bhk,hkd->bd"), (k_cache, v_cache)


def seq_split(cfg, dist) -> bool:
    """Whether the decode cache is split over the model axis by sequence:
    on a mesh whose model axis the kv heads do not divide (the cache length
    must divide it then; ``Model.prefill`` and the engine check)."""
    m = dist.model_size if on_mesh(dist) else 1
    return m > 1 and cfg.num_kv_heads % m != 0


def _split_decode(q, k_cache, v_cache, valid, dist) -> torch.Tensor:
    """Attention of one query a sequence over a cache whose positions are
    split over the model axis: q ``[B, H, D]``, this rank's block ``[B, Tl,
    KH, D]`` with ``valid [B]`` filled positions in it. Each rank's partial
    softmax (max, sum, unnormalised output, f32) is combined with the
    others' by an all-max and two all-reduces."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * d**-0.5
    ok = torch.arange(t, device=q.device)[None] < valid[:, None]
    s = torch.where(ok[:, None, None], s, NEG_INF)
    m_loc = s.amax(dim=-1)
    pr = torch.exp(s - m_loc[..., None])
    pr = torch.where(ok[:, None, None], pr, 0.0)
    o = torch.einsum("bkgt,btkd->bkgd", pr.to(v_cache.dtype).float(), v_cache.float())
    axes = _model(dist)
    w = torch.exp(m_loc - dist_lib.all_max(m_loc, dist, axes))
    num = dist_lib.all_reduce(o * w[..., None], dist, axes)
    den = dist_lib.all_reduce(pr.sum(dim=-1) * w, dist, axes)
    return (num / torch.clamp_min(den, 1e-30)[..., None]).to(v_cache.dtype).reshape(b, h, d)


def mlp_apply(p: dict, x: torch.Tensor, cfg, dist, hot_ids: torch.Tensor | None = None):
    """Pre-norm FFN (dense swiglu or GELU, or MoE). Returns ``(y,
    moe_stats|None)``. A swiglu whose width is split over the model axis
    (TP) takes a replicated input and all-reduces its partial output."""
    xn = apply_norm(p["ln"], x, cfg.norm)
    stats = None
    if cfg.num_experts:
        y, stats = moe_lib.moe_apply(p, xn, cfg, dist, hot_ids)
    elif cfg.act == "gelu":
        if p["w_in"].shape[-1] < cfg.d_ff:
            raise NotImplementedError("a GELU MLP split over the model axis: its bias would be summed")
        y = gelu_mlp(p, xn)
    else:
        y = moe_lib.swiglu_tp(p, xn, dist, cfg.d_ff)
    return x + y, stats


# ---------------------------------------------------------------------------
# Layer-stack execution


def _reduce_layer_stats(stats: list | None) -> dict | None:
    """Per-layer MoE stats stacked over layers: counts keep their layer
    resolution ``[L, G, E]``, the scalars are averaged."""
    if not stats:
        return None
    return {
        "counts": torch.stack([st["counts"] for st in stats]),
        **{key: torch.stack([st[key] for st in stats]).mean() for key in ("aux", "dropped", "hot_frac")},
    }


def _layer_entries(gathers):
    """A layer's entries: the stacked entries less the layers dim."""
    if gathers is None:
        return None
    if isinstance(gathers, dict):
        return {k: _layer_entries(v) for k, v in gathers.items()}
    return tuple(gathers[1:])


def _gather_layer(layer: dict, entries, dist) -> dict:
    if entries is None or not on_mesh(dist):
        return layer
    return dist_lib.gather_tree(layer, entries, dist)


def _maybe_remat(fn, cfg):
    """``fn`` under activation checkpointing when ``cfg.remat == "full"``:
    its activations are recomputed in the backward pass (the reference's
    ``jax.checkpoint``)."""
    if cfg.remat != "full":
        return fn

    def remat(*args):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)

    return remat


def run_decoder(
    blocks: dict,
    h: torch.Tensor,  # [B, S, D] embedded inputs
    cfg,
    dist=None,
    *,
    mode: str = "train",
    window: int = 0,
    attn_chunk: int = 1024,
    hot_ids: torch.Tensor | None = None,  # [L, R] per-layer replica sets
    gathers=None,
):
    """Run the stacked blocks over ``h``. Returns ``(hidden, cache|None,
    moe_stats|None)``. ``mode="prefill"`` fills the cache ``[L, B, S, KH,
    Dh]`` layer by layer in place; ``mode="train"`` collects none and
    attends blockwise in chunks of ``attn_chunk``. On a mesh, ``gathers``
    (the stacked blocks' partition entries of the dims their compute
    gathers) gathers each layer's params inside its body (ZeRO-3: under
    remat, again in the backward pass); the cache holds the kv heads the
    params hold."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"run_decoder mode={mode!r}; expected 'train' or 'prefill'")
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)
    l, dh = cfg.num_layers, cfg.resolved_head_dim
    kh = blocks["attn"]["wk"].shape[-2]
    train = mode == "train"
    layer_gathers = _layer_entries(gathers)
    if not train:
        k_all = torch.empty((l, b, s, kh, dh), dtype=h.dtype, device=h.device)
        v_all = torch.empty_like(k_all)
    chunk = attn_chunk if train else None

    def body(x, layer, hids):
        layer = _gather_layer(layer, layer_gathers, dist)
        x, (k, v) = attn_full(layer["attn"], x, cfg, dist, positions, window, chunk)
        x, st = mlp_apply(layer["mlp"], x, cfg, dist, hids)
        return x, st, (None if train else (k, v))

    if train:
        body = _maybe_remat(body, cfg)
    stats = []
    for i, layer in enumerate(_unstack(blocks, l)):
        h, st, kv = body(h, layer, None if hot_ids is None else hot_ids[i])
        if kv is not None:
            k_all[i], v_all[i] = kv
        if st is not None:
            stats.append(st)
    cache = None
    if not train:
        length = torch.full((b,), s, dtype=torch.int32, device=h.device)
        cache = KVCache(k=k_all, v=v_all, length=length)
    return h, cache, _reduce_layer_stats(stats)


def run_decode_step(
    blocks: dict,
    x: torch.Tensor,  # [B, D] — embedded new token
    cache: KVCache,
    cfg,
    dist=None,
    *,
    window: int = 0,
    hot_ids: torch.Tensor | None = None,  # [L, R]
    gathers=None,
):
    """One token through all layers. Each layer writes one ``[B, KH, Dh]``
    row into the cache in place and attends over its layer's slice; int8
    params are dequantized a layer at a time (and on a mesh gathered by
    ``gathers``, as in ``run_decoder``). Returns ``(x, cache,
    moe_stats|None)``; the cache's tensors are the ones passed in, with
    ``length + 1``."""
    stats = []
    layer_gathers = _layer_entries(gathers)
    for i, layer in enumerate(_unstack(blocks, cfg.num_layers)):
        layer = _gather_layer(dequant_tree(layer), layer_gathers, dist)
        x, _ = attn_decode(layer["attn"], x, cache.k[i], cache.v[i], cache.length, cfg, dist, window)
        y, st = mlp_apply(layer["mlp"], x[:, None, :], cfg, dist,
                          None if hot_ids is None else hot_ids[i])
        x = y[:, 0]
        if st is not None:
            stats.append(st)
    return x, cache._replace(length=cache.length + 1), _reduce_layer_stats(stats)
