"""Plain PyTorch version of flash decode (counterpart of
``src/repro/kernels/flash_decode/``): the Pallas kernel's online softmax
over cache blocks of 512 in its op order, for every (sequence, kv head)
at once — the yardstick the CUDA kernels in ``csrc/flash_decode.cu`` are
held to, and what the wrapper runs for tensors on the CPU.

Positions at or past ``lengths[b]`` are masked (a length past T admits the
whole cache); scores and sums are f32, ``p`` is rounded to v's dtype before
the PV product, and the output is ``acc / max(l, 1e-30)`` in q's dtype."""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "BLOCK", "flash_decode_ref"]

NEG_INF = -1e30
BLOCK = 512  # cache positions per block, the reference kernel's default


def flash_decode_ref(
    q: torch.Tensor,  # [B, H, D]
    k_cache: torch.Tensor,  # [B, T, KH, D]
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # [B] int
) -> torch.Tensor:
    b, h, d = q.shape
    t, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = d**-0.5
    qg = q.float().reshape(b, kh, g, d)
    acc = torch.zeros((b, kh, g, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, kh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kh, g), dtype=torch.float32, device=q.device)
    lengths = lengths.to(q.device)
    for k0 in range(0, t, BLOCK):
        kc = k_cache[:, k0 : k0 + BLOCK].float()
        vc = v_cache[:, k0 : k0 + BLOCK]
        k_pos = torch.arange(k0, k0 + kc.shape[1], device=q.device)
        ok = k_pos[None, :] < lengths[:, None]  # [B, n]
        sc = torch.einsum("bkgd,btkd->bkgt", qg, kc) * scale
        sc = torch.where(ok[:, None, None], sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bkgt,btkd->bkgd", p.to(v_cache.dtype).float(), vc.float())
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, h, d).to(q.dtype)
