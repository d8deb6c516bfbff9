"""Attention in torch ops (counterpart of ``src/repro/models/attention.py``).

``blockwise_attention`` is what training runs, as in the reference: an
exact flash-style pass in plain ops under autograd (the reference's is
plain ``jnp`` under ``jax.grad``, with no kernel), its kv chunk range
static per q chunk (stopping at the causal diagonal, starting at the window
edge), the running ``(acc, m, l)`` in f32 and the output cast to q's
dtype. Prefill and decode do not call this module: they go through the
``flash_attention`` and ``flash_decode`` kernels (``models/transformer.py``).
``dense_attention`` and ``decode_attention`` are the straightforward
versions the tests hold the reference's functions against. GQA is
computed grouped (``[B, S, KH, G, D]`` against ``[B, T, KH, D]``)."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "dense_attention", "blockwise_attention", "decode_attention"]

NEG_INF = -1e30


def _split_groups(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """[B, S, H, D] -> [B, S, KH, G, D]"""
    b, s, h, d = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, d)


def _merge_groups(x: torch.Tensor) -> torch.Tensor:
    """[B, S, KH, G, D] -> [B, S, H, D]"""
    b, s, kh, g, d = x.shape
    return x.reshape(b, s, kh * g, d)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int,
          kv_len: int = 0) -> torch.Tensor:
    """``[Sq, Sk]`` bool — True = attend. Causal / sliding-window / kv padding."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    if kv_len:
        ok &= k_pos[None, :] < kv_len
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


def _block(qg, kc, vc, q_pos, k_pos, carry, causal, window, scale, kv_len=0):
    """One (q-chunk, k-chunk) online-softmax step. qg ``[B, C, KH, G, D]``;
    kc, vc ``[B, C, KH, D]``; carry ``(acc, m, l)`` in f32. Scores are f32
    sums of exact products (the reference's ``preferred_element_type``);
    p is rounded to v's dtype and ``p @ v`` rounded to it, as there."""
    acc, m, l = carry
    s = torch.einsum("bqkgd,btkd->bkgqt", qg.float(), kc.float()) * scale
    ok = _mask(q_pos, k_pos, causal, window, kv_len)
    s = torch.where(ok, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(vc.dtype).float(), vc.float()).to(vc.dtype).float()
    acc = acc * alpha[..., None] + pv
    return acc, m_new, l


def blockwise_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KH, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Exact flash-style attention (see the module docstring). q and kv
    lengths that ``chunk`` does not divide are padded; padded keys are
    masked and padded query rows dropped."""
    b, sq, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    chunk = min(chunk, sq, t)
    q_pad = (-sq) % chunk
    if q_pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, q_pad))
    kv_len = 0
    if t % chunk:
        kv_len = t  # the real length, for the mask
        pad = chunk - t % chunk
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        t += pad
    sq_padded = sq + q_pad
    nq, nk = sq_padded // chunk, t // chunk
    scale = d**-0.5
    g = h // kh
    dev = q.device
    out_chunks = []
    for i in range(nq):
        q_lo = i * chunk
        q_pos = torch.arange(chunk, device=dev) + q_lo + q_offset
        qg = _split_groups(q[:, q_lo : q_lo + chunk], kh)
        # Static kv chunk range: stop at the causal diagonal, start at the
        # window edge; skipped chunks cost nothing.
        hi = nk if not causal else min(nk, (q_lo + q_offset + chunk + chunk - 1) // chunk)
        lo = 0 if not window else max(0, (q_lo + q_offset - window + 1) // chunk)
        carry = (torch.zeros((b, kh, g, chunk, d), dtype=torch.float32, device=dev),
                 torch.full((b, kh, g, chunk), NEG_INF, dtype=torch.float32, device=dev),
                 torch.zeros((b, kh, g, chunk), dtype=torch.float32, device=dev))
        for j in range(lo, hi):
            k_pos = torch.arange(chunk, device=dev) + j * chunk
            kc, vc = k[:, j * chunk : (j + 1) * chunk], v[:, j * chunk : (j + 1) * chunk]
            carry = _block(qg, kc, vc, q_pos, k_pos, carry, causal, window, scale, kv_len)
        acc, _, l = carry
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        out_chunks.append(_merge_groups(out.permute(0, 3, 1, 2, 4)).to(q.dtype))  # [B, C, H, D]
    result = torch.cat(out_chunks, dim=1)
    return result[:, :sq] if q_pad else result


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
