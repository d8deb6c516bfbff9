"""Plain PyTorch version of flash attention (counterpart of
``src/repro/kernels/flash_attention/``): the Pallas kernel's online
softmax in its op order, kv block by kv block, over all q rows at once —
the yardstick the CUDA kernel in ``csrc/flash_attention.cu`` is held to,
and what the wrapper runs for tensors on the CPU.

Scores are taken in f32 (q and k cast first, as the Pallas kernel casts
them); ``p`` is rounded to v's dtype before the PV product, whose
products are exact in f32 and summed in f32; the output is
``acc / max(l, 1e-30)`` in q's dtype. A short last kv block stands for the
reference's masked padding."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "BLOCK", "flash_attention_ref"]

NEG_INF = -1e30
BLOCK = 64  # kv rows per block, the CUDA kernel's tile


def flash_attention_ref(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, T, KH, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d**-0.5
    qg = q.float().reshape(b, s, kh, g, d)
    q_pos = torch.arange(s, device=q.device)[:, None]
    acc = torch.zeros((b, kh, g, s, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g, s), dtype=torch.float32, device=q.device)
    for k0 in range(0, t, BLOCK):
        kc = k[:, k0 : k0 + BLOCK].float()
        vc = v[:, k0 : k0 + BLOCK]
        k_pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)[None, :]
        ok = torch.ones((s, kc.shape[1]), dtype=torch.bool, device=q.device)
        if causal:
            ok &= q_pos >= k_pos
        if window:
            ok &= (q_pos - k_pos) < window
        sc = torch.einsum("bskgd,btkd->bkgst", qg, kc) * scale
        sc = torch.where(ok, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype).float(), vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)
