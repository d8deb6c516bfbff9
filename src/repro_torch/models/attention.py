"""Plain attention (counterpart of ``dense_attention``, ``decode_attention``
and ``_mask`` in ``src/repro/models/attention.py``).

The model path does not call these: prefill goes through the
``flash_attention`` kernel and decode through ``flash_decode``
(``models/transformer.py``). They are the straightforward versions the
tests hold the reference's functions against. GQA is computed grouped
(``[B, S, KH, G, D]`` against ``[B, T, KH, D]``)."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "dense_attention", "decode_attention"]

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """``[Sq, Sk]`` bool — True = attend. Causal / sliding-window."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return ok


def dense_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Sk, KH, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Full masked attention, f32 scores and softmax; ``q_offset`` is q's
    global position of index 0 relative to k."""
    b, sq, h, d = q.shape
    kh = k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), k.float())
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(k.shape[1], device=q.device)
    s = torch.where(_mask(q_pos, k_pos, causal, window), s * d**-0.5, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype).float(), v.float()).to(v.dtype)
    return out.reshape(b, sq, h, d)


def decode_attention(
    q: torch.Tensor,  # [B, H, D] — one new token per sequence
    k_cache: torch.Tensor,  # [B, T, KH, D]
    v_cache: torch.Tensor,
    length: torch.Tensor,  # [B] int — valid cache entries (new token included)
) -> torch.Tensor:
    """Single-position attention over a KV cache, masked to ``length``."""
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, kh, h // kh, d)
    s = torch.einsum("bkgd,btkd->bkgt", qg.float(), k_cache.float()) * d**-0.5
    valid = torch.arange(t, device=q.device)[None] < length.to(q.device)[:, None]  # [B, T]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.to(v_cache.dtype).reshape(b, h, d)
