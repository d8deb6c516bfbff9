"""Whisper-style encoder-decoder backbone (counterpart of
``src/repro/models/encdec.py``).

The conv audio frontend is a stub, as in the reference: the inputs are
precomputed frame embeddings ``[B, F, D]`` (F = 1500 for 30 s of audio).
Encoder: bidirectional self-attention and a GELU MLP; decoder: causal
self-attention, cross-attention over the encoder memory and a GELU MLP;
both pre-LayerNorm with parameter-free sinusoidal positions.

The decode state is the decoder's self-attention cache and the
cross-attention K/V, projected once from the encoder memory at prefill and
read-only after. Serving attention goes through the kernels: the encoder
(non-causal, T = S = F) and the decoder's prefill through
``flash_attention``, the prefill's cross attention through it too (T = F
!= S), and at decode both the self attention over the cache and the cross
attention over the memory through ``flash_decode``. The decode step writes
each layer's new self-attention row in place, as ``run_decode_step`` does.

Training (``encode`` and ``decode_prefill`` with ``train=True``) takes the
reference's route: every attention through ``blockwise_attention`` in
chunks of ``cfg.attn_chunk`` (the encoder's non-causal, the decoder's
causal, the cross attention non-causal over a memory that the chunk need
not divide), each layer's body under activation checkpointing when
``cfg.remat == "full"``. The training decoder keeps no caches: the loss
does not read them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import apply_norm, norm_specs

__all__ = [
    "EncDecState",
    "encdec_specs",
    "init_encdec_state",
    "sinusoid",
    "encode",
    "decode_prefill",
    "encdec_decode_step",
]


class EncDecState(NamedTuple):
    self_k: torch.Tensor  # [Ld, B, T, KH, Dh] bf16
    self_v: torch.Tensor
    cross_k: torch.Tensor  # [Ld, B, F, KH, Dh] bf16
    cross_v: torch.Tensor
    length: torch.Tensor  # [B] int32


def init_encdec_state(cfg, batch: int, cache_len: int, abstract: bool = False,
                      device=None) -> EncDecState:
    """Zeroed state on ``device``; ``abstract`` gives shapes and dtypes only
    (tensors on the ``meta`` device)."""
    kh, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    l, f = cfg.num_layers, cfg.num_frames
    dev = "meta" if abstract else device

    def mk(shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return EncDecState(
        self_k=mk((l, batch, cache_len, kh, dh)), self_v=mk((l, batch, cache_len, kh, dh)),
        cross_k=mk((l, batch, f, kh, dh)), cross_v=mk((l, batch, f, kh, dh)),
        length=mk((batch,), torch.int32),
    )


def encdec_specs(cfg) -> dict:
    enc_prefix = ((cfg.encoder_layers, "layers"),)
    dec_prefix = ((cfg.num_layers, "layers"),)
    return {
        "encoder": {
            "attn": tfm.attn_specs(cfg, enc_prefix),
            "mlp": tfm.mlp_specs(cfg, enc_prefix),
            "ln_post": norm_specs(cfg.d_model, cfg.norm),
        },
        "decoder": {
            "attn": tfm.attn_specs(cfg, dec_prefix),
            "cross": tfm.attn_specs(cfg, dec_prefix),
            "mlp": tfm.mlp_specs(cfg, dec_prefix),
        },
    }


def _inv_freq(d: int, device) -> torch.Tensor:
    """``exp(-i * log(10000) / (d/2 - 1))`` in f32, each step rounded as the
    reference's f32 ops round it."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    step = torch.log(torch.tensor(10000.0, dtype=torch.float32, device=device)) / max(d // 2 - 1, 1)
    return torch.exp(-dim * step)


def sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    """The parameter-free sinusoidal position table ``[length, d]`` (f32)."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_freq(d, device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding at positions ``[B]`` -> ``[B, d]`` (f32)."""
    ang = positions.float()[:, None] * _inv_freq(d, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def encode(params: dict, frames: torch.Tensor, cfg, dist=None, train: bool = False) -> torch.Tensor:
    """frames ``[B, F, D]`` (stub embeddings) -> the encoder memory ``[B,
    F, D]``. ``train`` takes the training route (module docstring)."""
    b, f, d = frames.shape
    h = frames + sinusoid(f, d, frames.device).to(frames.dtype)[None]
    positions = torch.arange(f, device=frames.device)
    enc = params["encoder"]
    chunk = cfg.attn_chunk if train else None

    def body(x, layer):
        x, _ = tfm.attn_full(layer["attn"], x, cfg, dist, positions, 0, chunk, causal=False)
        x, _ = tfm.mlp_apply(layer["mlp"], x, cfg, dist)
        return x

    if train:
        body = tfm._maybe_remat(body, cfg)
    for layer in tfm._unstack({"attn": enc["attn"], "mlp": enc["mlp"]}, cfg.encoder_layers):
        h = body(h, layer)
    return apply_norm(enc["ln_post"], h, cfg.norm)


def decode_prefill(params: dict, tokens_embedded: torch.Tensor, memory: torch.Tensor, cfg, dist=None,
                   train: bool = False):
    """The full decoder pass over ``tokens_embedded [B, S, D]`` (positions
    already added). Returns ``(hidden, (self_k, self_v), (cross_k,
    cross_v))``, each cache stacked ``[L, B, ., KH, Dh]``; with ``train``
    (the training route, module docstring) ``(hidden, None, None)``."""
    b, s, _ = tokens_embedded.shape
    positions = torch.arange(s, device=tokens_embedded.device)
    l, kh, dh, f = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, memory.shape[1]
    layers = tfm._unstack(params["decoder"], l)
    x = tokens_embedded
    if train:
        def body(x, layer):
            x, _ = tfm.attn_full(layer["attn"], x, cfg, dist, positions, 0, cfg.attn_chunk, causal=True)
            kv = tfm.cross_attn_kv(layer["cross"], memory, cfg)
            x = tfm.cross_attn(layer["cross"], x, kv, cfg, dist, cfg.attn_chunk)
            x, _ = tfm.mlp_apply(layer["mlp"], x, cfg, dist)
            return x

        body = tfm._maybe_remat(body, cfg)
        for layer in layers:
            x = body(x, layer)
        return x, None, None
    dt, dev = tokens_embedded.dtype, tokens_embedded.device
    k_all, v_all = (torch.empty((l, b, s, kh, dh), dtype=dt, device=dev) for _ in range(2))
    ck_all, cv_all = (torch.empty((l, b, f, kh, dh), dtype=dt, device=dev) for _ in range(2))
    for i, layer in enumerate(layers):
        x, (k_all[i], v_all[i]) = tfm.attn_full(layer["attn"], x, cfg, dist, positions, 0, causal=True)
        ck_all[i], cv_all[i] = tfm.cross_attn_kv(layer["cross"], memory, cfg)
        x = tfm.cross_attn(layer["cross"], x, (ck_all[i], cv_all[i]), cfg, dist)
        x, _ = tfm.mlp_apply(layer["mlp"], x, cfg, dist)
    return x, (k_all, v_all), (ck_all, cv_all)


def encdec_decode_step(params: dict, x: torch.Tensor, state: EncDecState, cfg, dist=None):
    """One token ``x [B, D]`` (embedded, its position added by the caller)
    through the decoder. Each layer writes its self-attention row into the
    cache in place; the cross K/V are read only. Returns ``(x,
    EncDecState)`` with ``length + 1``."""
    pos = state.length.to(torch.int32)
    for i, layer in enumerate(tfm._unstack(params["decoder"], cfg.num_layers)):
        p = layer["attn"]
        xn = apply_norm(p["ln"], x[:, None, :], cfg.norm)
        q, k, v = tfm._project_qkv(p, xn, cfg)
        kc, vc = state.self_k[i], state.self_v[i]
        tfm._write_row(kc, pos, k[:, 0])
        tfm._write_row(vc, pos, v[:, 0])
        # Through the transformer module, where the model's kernels are bound.
        o = tfm.flash_decode(q[:, 0].contiguous(), kc, vc, (state.length + 1).to(torch.int32))
        x = x + torch.einsum("bhk,hkd->bd", o, p["wo"])
        y = tfm.cross_attn(layer["cross"], x[:, None, :], (state.cross_k[i], state.cross_v[i]), cfg, dist)
        y, _ = tfm.mlp_apply(layer["mlp"], y, cfg, dist)
        x = y[:, 0]
    return x, state._replace(length=state.length + 1)
