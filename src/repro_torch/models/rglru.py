"""RecurrentGemma blocks (counterpart of ``src/repro/models/rglru.py``): the
RG-LRU recurrence and local attention in a 1:2 pattern (every
``attention_period``-th layer attends over a sliding window; the rest are
gated linear recurrences).

Recurrent block: x -> RMSNorm -> {linear -> conv1d(4) -> RG-LRU} * gelu(linear)
-> linear -> residual. RG-LRU::

    r_t = sigmoid(W_a y_t + b_a)          (recurrence gate, block-diagonal W)
    i_t = sigmoid(W_x y_t + b_x)          (input gate)
    log a_t = -c * softplus(lam) * r_t    (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

A prefill composes the recurrence's affine steps with ``associative_scan``,
which writes out ``jax.lax.associative_scan``'s recursion (jax 0.9): the
same products in the same order, in O(log S) rounds of torch ops. A decode
step is the same block at S = 1. The attention layers keep ring buffers of
the last ``window`` positions (slot = position % window); prefill attends
through ``flash_attention`` with the window, decode through
``flash_decode`` over the ring (``transformer.attn_decode``, which writes
the ring in place). The layer pattern is heterogeneous, so the params are
per-layer lists, as in the reference.

Training (``rglru_forward(train=True)``) takes the reference's route:
the attention layers attend through ``blockwise_attention`` in chunks of
``cfg.attn_chunk`` with the window, and with ``cfg.remat == "full"`` each
recurrent block and each attention block runs under activation
checkpointing (the MLP blocks do not), as the reference wraps them in
``jax.checkpoint``. ``associative_scan`` writes its interleaved halves
into a ``new_empty`` tensor by slices, which autograd differentiates as
it does any slice write.

The recurrence, the gates and the convolution are plain ``jnp`` in the
reference, outside any Pallas kernel, so they are torch ops here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, gelu, norm_specs, swiglu_specs
from repro_torch.models.params import ParamSpec, dense_init, ones_init, zeros_init

__all__ = [
    "layer_kinds",
    "rglru_block_specs",
    "RGLRUState",
    "init_rglru_state",
    "rglru_forward",
    "rglru_decode_step",
]

CONV_WIDTH = 4
LRU_C = 8.0


def layer_kinds(cfg) -> list[str]:
    """``['rec', 'rec', 'attn', ...]``: every period-th layer attends."""
    p = cfg.attention_period
    return ["attn" if p and (i % p == p - 1) else "rec" for i in range(cfg.num_layers)]


class RGLRUState(NamedTuple):
    """Decode-time state; lists indexed by rec or attn layer ordinal."""

    conv: list  # per rec layer [B, CONV_WIDTH - 1, W] bf16
    h: list  # per rec layer [B, W] f32
    caches: list  # per attn layer (k, v) ring buffers [B, window, KH, Dh] bf16
    length: torch.Tensor  # [B] int32 tokens so far


def init_rglru_state(cfg, batch: int, abstract: bool = False, device=None) -> RGLRUState:
    """Zeroed state on ``device``; ``abstract`` gives shapes and dtypes only
    (tensors on the ``meta`` device)."""
    w = cfg.lru_width or cfg.d_model
    kinds = layer_kinds(cfg)
    window = cfg.window or 2048
    kh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    dev = "meta" if abstract else device

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return RGLRUState(
        conv=[mk((batch, CONV_WIDTH - 1, w), torch.bfloat16) for k in kinds if k == "rec"],
        h=[mk((batch, w), torch.float32) for k in kinds if k == "rec"],
        caches=[(mk((batch, window, kh, dh), torch.bfloat16), mk((batch, window, kh, dh), torch.bfloat16))
                for k in kinds if k == "attn"],
        length=mk((batch,), torch.int32),
    )


# ---------------------------------------------------------------------------
# Parameter declarations (per layer: the stack is a list, not stacked tensors)


def _rec_specs(cfg) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    nb = cfg.num_heads  # block-diagonal gate blocks
    bs = w // nb
    return {
        "ln": norm_specs(d, cfg.norm),
        "w_in": ParamSpec((d, w), ("embed", "state"), dense_init(d)),
        "w_gate_in": ParamSpec((d, w), ("embed", "state"), dense_init(d)),
        "conv_w": ParamSpec((CONV_WIDTH, w), (None, "state"), dense_init(CONV_WIDTH)),
        "conv_b": ParamSpec((w,), ("state",), zeros_init),
        "gate_a": ParamSpec((nb, bs, bs), (None, None, None), dense_init(bs)),
        "gate_a_b": ParamSpec((w,), ("state",), zeros_init),
        "gate_x": ParamSpec((nb, bs, bs), (None, None, None), dense_init(bs)),
        "gate_x_b": ParamSpec((w,), ("state",), zeros_init),
        "lam": ParamSpec((w,), ("state",), ones_init, torch.float32),
        "w_out": ParamSpec((w, d), ("state", "embed"), dense_init(w)),
    }


def _mlp_specs(cfg) -> dict:
    # A GeGLU MLP: swiglu's shapes, a GELU gate.
    return {"ln": norm_specs(cfg.d_model, cfg.norm), **swiglu_specs(cfg.d_model, cfg.d_ff)}


def rglru_block_specs(cfg) -> dict:
    kinds = layer_kinds(cfg)
    return {
        "rec": [_rec_specs(cfg) for k in kinds if k == "rec"],
        "attn": [tfm.attn_specs(cfg, ()) for k in kinds if k == "attn"],
        "mlp": [_mlp_specs(cfg) for _ in kinds],
    }


# ---------------------------------------------------------------------------
# RG-LRU core


def _combine(left, right):
    """Compose two affine steps ``h -> a h + b``: ``left`` first."""
    al, bl = left
    ar, br = right
    return al * ar, bl * ar + br


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """``even`` at the even indices along ``dim``, ``odd`` at the odd ones
    (``even`` as long as ``odd`` or one longer)."""
    n = even.shape[dim] + odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = n
    out = even.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = even
    out[(slice(None),) * dim + (slice(1, None, 2),)] = odd
    return out


def associative_scan(elems: tuple, dim: int) -> tuple:
    """Inclusive scan of ``(a, b)`` affine steps along ``dim`` by
    ``_combine``, written out as ``jax.lax.associative_scan`` runs it: the
    adjacent pairs combined, the scan of those pairs (recursively), the
    even positions combined from it, the first element put in front, and
    the two halves interleaved. ``O(log S)`` rounds of torch ops."""

    def take(x, start, stop=None, step=1):
        return x[(slice(None),) * dim + (slice(start, stop, step),)]

    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = _combine(tuple(take(e, 0, n - 1, 2) for e in elems),
                       tuple(take(e, 1, None, 2) for e in elems))
    odd = associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine(tuple(take(e, 0, -1) for e in odd), tuple(take(e, 2, None, 2) for e in elems))
    else:
        even = _combine(odd, tuple(take(e, 2, None, 2) for e in elems))
    even = tuple(torch.cat([take(e, 0, 1), r], dim=dim) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def _block_diag_gate(w: torch.Tensor, b: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear and sigmoid: y ``[..., W]`` -> f32 ``[..., W]``."""
    nb, bs, _ = w.shape
    yb = y.reshape(*y.shape[:-1], nb, bs)
    out = torch.einsum("...nb,nbc->...nc", yb, w.to(y.dtype))
    return torch.sigmoid(out.reshape(y.shape).float() + b.float())


def _lru_coeffs(p: dict, y: torch.Tensor):
    """Per-token decay ``a_t`` and input ``b_t`` (both f32 ``[B, S, W]``)."""
    r = _block_diag_gate(p["gate_a"], p["gate_a_b"], y)
    i = _block_diag_gate(p["gate_x"], p["gate_x_b"], y)
    log_a = -LRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * y.float())
    return a, b


def _causal_conv(p: dict, y: torch.Tensor, carry: torch.Tensor | None):
    """Depthwise causal convolution of width 4; ``carry [B, 3, W]`` holds
    the previous inputs. Returns ``(out, carry')``."""
    b, s, w = y.shape
    if carry is None:
        carry = torch.zeros((b, CONV_WIDTH - 1, w), dtype=y.dtype, device=y.device)
    ext = torch.cat([carry.to(y.dtype), y], dim=1)  # [B, S + 3, W]
    out = sum(ext[:, i : i + s] * p["conv_w"][i].to(y.dtype) for i in range(CONV_WIDTH))
    return out + p["conv_b"].to(y.dtype), ext[:, -(CONV_WIDTH - 1):]


def rec_block(p: dict, x: torch.Tensor, cfg, conv_carry: torch.Tensor | None = None,
              h0: torch.Tensor | None = None):
    """The recurrent block over x ``[B, S, D]``. Returns ``(y, conv_carry',
    h_last)``."""
    xn = apply_norm(p["ln"], x, cfg.norm)
    y = torch.einsum("bsd,dw->bsw", xn, p["w_in"])
    gate = F.gelu(torch.einsum("bsd,dw->bsw", xn, p["w_gate_in"]).float(), approximate="tanh")
    y, conv_carry = _causal_conv(p, y, conv_carry)
    a, bb = _lru_coeffs(p, y)
    va, vb = associative_scan((a, bb), 1)  # prefix composition: h_t = A_t h0 + B_t
    h = vb if h0 is None else va * h0[:, None].float() + vb
    out = h * gate
    y_out = torch.einsum("bsw,wd->bsd", out.to(x.dtype), p["w_out"])
    return x + y_out, conv_carry, h[:, -1]


def rec_block_step(p: dict, x: torch.Tensor, cfg, conv_carry: torch.Tensor, h0: torch.Tensor):
    """One decode step of the recurrent block, x ``[B, D]``."""
    y, conv_carry, h = rec_block(p, x[:, None, :], cfg, conv_carry, h0)
    return y[:, 0], conv_carry, h


def mlp_block(p: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """The GeGLU MLP with its pre-norm."""
    xn = apply_norm(p["ln"], x, cfg.norm)
    g = torch.einsum("bsd,df->bsf", xn, p["w_gate"])
    u = torch.einsum("bsd,df->bsf", xn, p["w_up"])
    return x + torch.einsum("bsf,fd->bsd", gelu(g) * u, p["w_down"])


# ---------------------------------------------------------------------------
# Stack execution (the heterogeneous pattern, layer by layer)


def rglru_forward(blocks: dict, h: torch.Tensor, cfg, dist=None, state: RGLRUState | None = None,
                  collect_cache: bool = False, train: bool = False):
    """Full-sequence forward. With ``collect_cache`` it builds the decode
    state: each attention layer's last ``window`` positions in its ring
    (slot = position % window) and each recurrent layer's final state.
    With ``train`` it is the training forward (blockwise attention, remat;
    see the module docstring). Returns ``(h, RGLRUState | None)``."""
    b, s, _ = h.shape
    window = cfg.window or 2048
    ri = ai = 0
    conv_out, h_out, cache_out = [], [], []
    positions = torch.arange(s, device=h.device)
    rec, attn, chunk = rec_block, tfm.attn_full, None
    if train:
        rec, attn, chunk = tfm._maybe_remat(rec_block, cfg), tfm._maybe_remat(tfm.attn_full, cfg), cfg.attn_chunk
    for li, kind in enumerate(layer_kinds(cfg)):
        if kind == "rec":
            conv0 = state.conv[ri] if state else None
            h0 = state.h[ri] if state else None
            h, conv1, hl = rec(blocks["rec"][ri], h, cfg, conv0, h0)
            if collect_cache:
                conv_out.append(conv1)
                h_out.append(hl)
            ri += 1
        else:
            h, (k, v) = attn(blocks["attn"][ai], h, cfg, dist, positions, window, chunk)
            if collect_cache:
                take = min(window, s)
                slots = positions[-take:] % window
                kc = torch.zeros((b, window, *k.shape[2:]), dtype=k.dtype, device=k.device)
                vc = torch.zeros_like(kc)
                kc[:, slots] = k[:, -take:]
                vc[:, slots] = v[:, -take:]
                cache_out.append((kc, vc))
            ai += 1
        h = mlp_block(blocks["mlp"][li], h, cfg)
    new_state = None
    if collect_cache:
        length = torch.full((b,), s, dtype=torch.int32, device=h.device)
        new_state = RGLRUState(conv=conv_out, h=h_out, caches=cache_out, length=length)
    return h, new_state


def rglru_decode_step(blocks: dict, x: torch.Tensor, cfg, state: RGLRUState, dist=None):
    """One token ``x [B, D]`` through every layer. The ring buffers are
    written in place; returns ``(x, RGLRUState)`` with new recurrent states
    and ``length + 1``."""
    window = cfg.window or 2048
    ri = ai = 0
    conv_out, h_out = [], []
    for li, kind in enumerate(layer_kinds(cfg)):
        if kind == "rec":
            x, conv1, h1 = rec_block_step(blocks["rec"][ri], x, cfg, state.conv[ri], state.h[ri])
            conv_out.append(conv1)
            h_out.append(h1)
            ri += 1
        else:
            kc, vc = state.caches[ai]
            x, _ = tfm.attn_decode(blocks["attn"][ai], x, kc, vc, state.length, cfg, dist,
                                   window=window)
            ai += 1
        x = mlp_block(blocks["mlp"][li], x[:, None, :], cfg)[:, 0]
    return x, RGLRUState(conv=conv_out, h=h_out, caches=state.caches, length=state.length + 1)
