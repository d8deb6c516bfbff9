"""RWKV-6 "Finch" blocks (counterpart of ``src/repro/models/rwkv6.py``):
attention-free token mixing with a data-dependent decay per channel.

Each layer is TimeMix (the wkv6 recurrence) and ChannelMix, both with a
pre-LayerNorm and the token shift's data-dependent interpolation (ddlerp
with a shared low-rank adapter). The wkv6 recurrence, per head of Dh = 64::

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S: [Dh, Dh], f32)
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

A prefill runs the chunked form, as the reference does: within a chunk of
``CHUNK`` tokens the intra-chunk part is a masked product weighted by the
decay, and the state moves once a chunk. The reference's ``lax.scan`` over
chunks is a Python loop over them here, and its scan over the stacked
layers a loop over ``torch.unbind`` views. A decode step is the same
``_wkv_chunk`` at C = 1. The chunk's ``exp(-cum)`` is as large as the
reference's (it is not rescaled): the decay is clipped so that a chunk of
32 tokens stays finite in f32 for the decays the model makes.

There is no kernel here: the reference's recurrence is plain ``jnp``
outside any Pallas kernel, so it is torch ops in the port. Decode returns
new state tensors; it writes nothing in place. Training runs the same
chunked form under autograd (``rwkv_forward(train=True)``), each layer
under activation checkpointing when ``cfg.remat == "full"``, as the
reference wraps its scan body in ``jax.checkpoint``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import layernorm
from repro_torch.models.params import ParamSpec, dense_init, ones_init, zeros_init
from repro_torch.models.transformer import _maybe_remat, _unstack

__all__ = ["RWKVState", "rwkv_block_specs", "rwkv_forward", "rwkv_decode_step", "init_rwkv_state"]

LORA_MIX = 32  # shared ddlerp adapter rank
LORA_DECAY = 64  # decay adapter rank
CHUNK = 32  # chunked-recurrence block length


class RWKVState(NamedTuple):
    """Per-layer recurrent state, stacked ``[L, ...]``."""

    x_tm: torch.Tensor  # [L, B, D] bf16, last input seen by TimeMix (token shift)
    x_cm: torch.Tensor  # [L, B, D] bf16, last input seen by ChannelMix
    wkv: torch.Tensor  # [L, B, H, Dh, Dh] f32 recurrence state


def init_rwkv_state(cfg, batch: int, abstract: bool = False, device=None) -> RWKVState:
    """Zeroed state on ``device``; ``abstract`` gives shapes and dtypes only
    (tensors on the ``meta`` device)."""
    h, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    dev = "meta" if abstract else device
    return RWKVState(
        x_tm=torch.zeros((cfg.num_layers, batch, cfg.d_model), dtype=torch.bfloat16, device=dev),
        x_cm=torch.zeros((cfg.num_layers, batch, cfg.d_model), dtype=torch.bfloat16, device=dev),
        wkv=torch.zeros((cfg.num_layers, batch, h, dh, dh), dtype=torch.float32, device=dev),
    )


def rwkv_block_specs(cfg) -> dict:
    d, f, l = cfg.d_model, cfg.d_ff, cfg.num_layers
    ps, pa = (l,), ("layers",)

    def vec(init=zeros_init):
        return ParamSpec(ps + (d,), pa + (None,), init, torch.float32)

    def ln():
        return {"scale": ParamSpec(ps + (d,), pa + (None,), ones_init, torch.float32),
                "bias": ParamSpec(ps + (d,), pa + (None,), zeros_init, torch.float32)}

    return {
        "tm": {
            "ln": ln(),
            "mu_x": vec(),
            "mu": ParamSpec(ps + (5, d), pa + (None, None), zeros_init, torch.float32),
            "lora_a": ParamSpec(ps + (d, 5 * LORA_MIX), pa + ("embed", None), dense_init(d)),
            "lora_b": ParamSpec(ps + (5, LORA_MIX, d), pa + (None, None, "embed"), zeros_init),
            "w_r": ParamSpec(ps + (d, d), pa + ("embed", "heads"), dense_init(d)),
            "w_k": ParamSpec(ps + (d, d), pa + ("embed", "heads"), dense_init(d)),
            "w_v": ParamSpec(ps + (d, d), pa + ("embed", "heads"), dense_init(d)),
            "w_g": ParamSpec(ps + (d, d), pa + ("embed", "heads"), dense_init(d)),
            "w_o": ParamSpec(ps + (d, d), pa + ("heads", "embed"), dense_init(d)),
            "decay_base": vec(),  # w0
            "decay_a": ParamSpec(ps + (d, LORA_DECAY), pa + ("embed", None), dense_init(d)),
            "decay_b": ParamSpec(ps + (LORA_DECAY, d), pa + (None, "embed"), zeros_init),
            "bonus": vec(),  # u, flattened [D] = [H * Dh]
            "ln_x": ln(),  # the per-head group norm's params (over Dh)
        },
        "cm": {
            "ln": ln(),
            "mu_r": vec(),
            "mu_k": vec(),
            "w_r": ParamSpec(ps + (d, d), pa + ("embed", "mlp"), dense_init(d)),
            "w_k": ParamSpec(ps + (d, f), pa + ("embed", "mlp"), dense_init(d)),
            "w_v": ParamSpec(ps + (f, d), pa + ("mlp", "embed"), dense_init(f)),
        },
    }


# ---------------------------------------------------------------------------
# TimeMix


def _ddlerp(p: dict, x: torch.Tensor, xx: torch.Tensor) -> list[torch.Tensor]:
    """Data-dependent lerp giving the 5 mixed inputs (r, k, v, g, w)."""
    base = x + xx * p["mu_x"].to(x.dtype)
    lo = torch.einsum("bsd,dr->bsr", base, p["lora_a"].to(x.dtype))
    lo = torch.tanh(lo.float()).reshape(*lo.shape[:-1], 5, LORA_MIX)
    delta = torch.einsum("bsir,ird->bsid", lo, p["lora_b"].float())
    mix = p["mu"].float()[None, None] + delta  # [B, S, 5, D]
    out = x[..., None, :] + xx[..., None, :] * mix.to(x.dtype)
    return [out[..., i, :] for i in range(5)]


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel log-decay in (-inf, 0): ``-exp(w0 + lora(xw))``, the
    exponent clipped to [-8, 4]."""
    lo = torch.einsum("bsd,dr->bsr", xw, p["decay_a"].to(xw.dtype))
    lo = torch.einsum("bsr,rd->bsd", torch.tanh(lo.float()), p["decay_b"].float())
    return -torch.exp(torch.clamp(p["decay_base"].float() + lo, -8.0, 4.0))


def _heads(x: torch.Tensor, dh: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], x.shape[-1] // dh, dh)


def _wkv_chunk(r, k, v, logw, u, s0):
    """One chunk of the wkv6 recurrence, all f32. r, k, v, logw ``[B, C, H,
    Dh]``; u ``[H, Dh]``; s0 ``[B, H, Dh, Dh]``. Returns ``(o [B, C, H,
    Dh], s1)``."""
    cum = torch.cumsum(logw, dim=1)  # inclusive per-channel decay log-product
    total = cum[:, -1]  # [B, H, Dh]
    # Keys normalised to the chunk's start, queries to t - 1 (the state before token t).
    q_t = r * torch.exp(cum - logw)
    k_i = k * torch.exp(-cum)
    scores = torch.einsum("bthd,bihd->bhti", q_t, k_i)
    c = r.shape[1]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device), diagonal=-1)
    intra = torch.einsum("bhti,bihd->bthd", torch.where(mask, scores, 0.0), v)
    diag = torch.einsum("bthd,bthd->bth", r * u[None, None], k)[..., None] * v
    inter = torch.einsum("bthd,bhde->bthe", q_t, s0)
    o = intra + diag + inter
    s1 = s0 * torch.exp(total)[..., None] + torch.einsum(
        "bihd,bihe->bhde", k * torch.exp(total[:, None] - cum), v)
    return o, s1


def _group_norm(p: dict, x: torch.Tensor, dh: int, eps: float = 1e-5) -> torch.Tensor:
    """Per-head LayerNorm over Dh (rwkv's GroupNorm(H)), population
    variance."""
    shape = x.shape
    xh = x.reshape(*shape[:-1], shape[-1] // dh, dh).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, keepdim=True, correction=0)
    xh = ((xh - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return xh * p["scale"].float() + p["bias"].float()


def time_mix(p: dict, x: torch.Tensor, cfg, x_prev: torch.Tensor, s0: torch.Tensor):
    """Full-sequence TimeMix: x ``[B, S, D]``, the token shift's carry-in
    ``x_prev [B, D]``, the state ``s0 [B, H, Dh, Dh]``. Returns ``(y,
    x_last, s_out)``. A sequence of ``CHUNK`` or more tokens must be a
    multiple of ``CHUNK`` (the reference asserts it)."""
    b, s, d = x.shape
    dh = cfg.rwkv_head_dim
    if s >= CHUNK and s % CHUNK:
        raise ValueError(f"time_mix: a sequence of {s} tokens is not a multiple of {CHUNK} "
                         f"(the reference asserts s % {CHUNK} == 0 or s < {CHUNK})")
    xn = layernorm(p["ln"]["scale"], p["ln"]["bias"], x)
    shifted = torch.cat([x_prev[:, None].to(xn.dtype), xn[:, :-1]], dim=1)
    xx = shifted - xn
    xr, xk, xv, xg, xw = _ddlerp(p, xn, xx)

    r = _heads(torch.einsum("bsd,de->bse", xr, p["w_r"]), dh).float()
    k = _heads(torch.einsum("bsd,de->bse", xk, p["w_k"]), dh).float()
    v = _heads(torch.einsum("bsd,de->bse", xv, p["w_v"]), dh).float()
    g = F.silu(torch.einsum("bsd,de->bse", xg, p["w_g"]).float())
    logw = _heads(_decay(p, xw), dh)  # [B, S, H, Dh]
    u = _heads(p["bonus"].float()[None], dh)[0]  # [H, Dh]

    if s < CHUNK:
        o, s_out = _wkv_chunk(r, k, v, logw, u, s0)
    else:
        outs, s_out = [], s0
        for c0 in range(0, s, CHUNK):
            part = slice(c0, c0 + CHUNK)
            o_c, s_out = _wkv_chunk(r[:, part], k[:, part], v[:, part], logw[:, part], u, s_out)
            outs.append(o_c)
        o = torch.cat(outs, dim=1)

    o = o.reshape(b, s, d)
    y = _group_norm(p["ln_x"], o, dh) * g
    y = torch.einsum("bse,ed->bsd", y.to(x.dtype), p["w_o"])
    return x + y, xn[:, -1], s_out


def channel_mix(p: dict, x: torch.Tensor, x_prev: torch.Tensor):
    """ChannelMix (rwkv's FFN). Returns ``(y, x_last)``."""
    xn = layernorm(p["ln"]["scale"], p["ln"]["bias"], x)
    shifted = torch.cat([x_prev[:, None].to(xn.dtype), xn[:, :-1]], dim=1)
    xx = shifted - xn
    xr = xn + xx * p["mu_r"].to(xn.dtype)
    xk = xn + xx * p["mu_k"].to(xn.dtype)
    rr = torch.sigmoid(torch.einsum("bsd,de->bse", xr, p["w_r"]).float())
    kk = torch.einsum("bsd,df->bsf", xk, p["w_k"])
    kk = torch.square(torch.relu(kk.float())).to(x.dtype)
    vv = torch.einsum("bsf,fd->bsd", kk, p["w_v"])
    return x + rr.to(x.dtype) * vv, xn[:, -1]


# ---------------------------------------------------------------------------
# Stack execution


def rwkv_forward(blocks: dict, h: torch.Tensor, cfg, dist=None, state: RWKVState | None = None,
                 train: bool = False):
    """All layers over a full sequence (prefill, or with ``train`` the
    training forward, each layer under ``_maybe_remat``). ``state`` carries
    in (zeros for a fresh sequence); returns ``(h, RWKVState)``."""
    if state is None:
        state = init_rwkv_state(cfg, h.shape[0], device=h.device)

    def body(x, p, x_tm0, x_cm0, wkv0):
        x, xt, st = time_mix(p["tm"], x, cfg, x_tm0, wkv0)
        x, xc = channel_mix(p["cm"], x, x_cm0)
        return x, xt, xc, st

    if train:
        body = _maybe_remat(body, cfg)
    x_tm, x_cm, wkv = [], [], []
    for i, p in enumerate(_unstack(blocks, cfg.num_layers)):
        h, xt, xc, st = body(h, p, state.x_tm[i], state.x_cm[i], state.wkv[i])
        x_tm.append(xt)
        x_cm.append(xc)
        wkv.append(st)
    return h, RWKVState(x_tm=torch.stack(x_tm), x_cm=torch.stack(x_cm), wkv=torch.stack(wkv))


def rwkv_decode_step(blocks: dict, x: torch.Tensor, cfg, state: RWKVState, dist=None):
    """One literal recurrence step a layer (O(1) in the context length):
    x ``[B, D]``, one token's embedding. Returns ``(x, RWKVState)``."""
    h, new = rwkv_forward(blocks, x[:, None, :], cfg, dist, state)
    return h[:, 0], new
