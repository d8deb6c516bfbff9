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

from repro_torch.dist import constrain
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import blockwise_attention
from repro_torch.models.layers import (apply_norm, gelu_mlp, gelu_mlp_specs, norm_specs, rope,
                                       swiglu, swiglu_specs)
from repro_torch.models.params import ParamSpec, dense_init, ones_init
from repro_torch.quant import dequant_tree

__all__ = [
    "KVCache",
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


# ---------------------------------------------------------------------------
# Parameter declarations


def attn_specs(cfg, prefix: tuple) -> dict:
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ps = tuple(s for s, _ in prefix)
    specs = {
        "ln": norm_specs(d, cfg.norm, prefix),
        "wq": ParamSpec(ps + (d, h, dh), dense_init(d)),
        "wk": ParamSpec(ps + (d, kh, dh), dense_init(d)),
        "wv": ParamSpec(ps + (d, kh, dh), dense_init(d)),
        "wo": ParamSpec(ps + (h, dh, d), dense_init(h * dh)),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec(ps + (dh,), ones_init, torch.float32)
        specs["k_norm"] = ParamSpec(ps + (dh,), ones_init, torch.float32)
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


def _project_qkv(p: dict, xn: torch.Tensor, cfg):
    q = torch.einsum("bsd,dhk->bshk", xn, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", xn, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", xn, p["wv"])
    if cfg.qk_norm:
        q = _rmsnorm_head(p["q_norm"], q)
        k = _rmsnorm_head(p["k_norm"], k)
    return q, k, v


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
    ``flash_attention`` kernel."""
    xn = apply_norm(p["ln"], x, cfg.norm)
    q, k, v = _project_qkv(p, xn, cfg)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, dist)
    if chunk is not None:
        o = blockwise_attention(q, k, v, causal=causal, window=window, chunk=chunk)
    else:
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                            window=window)
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return x + y, (k, v)


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
    """One decode step of one layer. Returns ``(y, (k_cache, v_cache))``."""
    xn = apply_norm(p["ln"], x[:, None, :], cfg.norm)
    q, k, v = _project_qkv(p, xn, cfg)
    pos, slot, valid = _decode_slot(length, k_cache.shape[1], window)
    if cfg.pos == "rope":
        q = rope(q, pos[:, None], cfg.rope_theta)
        k = rope(k, pos[:, None], cfg.rope_theta)
    _write_row(k_cache, slot, k[:, 0])
    _write_row(v_cache, slot, v[:, 0])
    o = flash_decode(q[:, 0].contiguous(), k_cache, v_cache, valid)
    y = torch.einsum("bhk,hkd->bd", o, p["wo"])
    return x + y, (k_cache, v_cache)


def mlp_apply(p: dict, x: torch.Tensor, cfg, dist, hot_ids: torch.Tensor | None = None):
    """Pre-norm FFN (dense swiglu or GELU, or MoE). Returns ``(y,
    moe_stats|None)``."""
    xn = apply_norm(p["ln"], x, cfg.norm)
    stats = None
    if cfg.num_experts:
        y, stats = moe_lib.moe_apply(p, xn, cfg, dist, hot_ids)
    elif cfg.act == "gelu":
        y = gelu_mlp(p, xn)
    else:
        y = swiglu(p, xn)
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
):
    """Run the stacked blocks over ``h``. Returns ``(hidden, cache|None,
    moe_stats|None)``. ``mode="prefill"`` fills the cache ``[L, B, S, KH,
    Dh]`` layer by layer in place; ``mode="train"`` collects none and
    attends blockwise in chunks of ``attn_chunk``."""
    if mode not in ("train", "prefill"):
        raise ValueError(f"run_decoder mode={mode!r}; expected 'train' or 'prefill'")
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device)
    l, kh, dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    train = mode == "train"
    if not train:
        k_all = torch.empty((l, b, s, kh, dh), dtype=h.dtype, device=h.device)
        v_all = torch.empty_like(k_all)
    chunk = attn_chunk if train else None

    def body(x, layer, hids):
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
):
    """One token through all layers. Each layer writes one ``[B, KH, Dh]``
    row into the cache in place and attends over its layer's slice; int8
    params are dequantized a layer at a time. Returns ``(x, cache,
    moe_stats|None)``; the cache's tensors are the ones passed in, with
    ``length + 1``."""
    stats = []
    for i, layer in enumerate(_unstack(blocks, cfg.num_layers)):
        layer = dequant_tree(layer)
        x, _ = attn_decode(layer["attn"], x, cache.k[i], cache.v[i], cache.length, cfg, dist, window)
        y, st = mlp_apply(layer["mlp"], x[:, None, :], cfg, dist,
                          None if hot_ids is None else hot_ids[i])
        x = y[:, 0]
        if st is not None:
            stats.append(st)
    return x, cache._replace(length=cache.length + 1), _reduce_layer_stats(stats)
