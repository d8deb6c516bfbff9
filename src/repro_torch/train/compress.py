"""Gradient compression for cross-pod reduction (counterpart of
``src/repro/train/compress.py``).

Two codecs, both with exact size accounting:

  * int8 quantisation — per-tensor symmetric scale, 4x fewer bytes than f32
    grads; unbiased by stochastic rounding, whose uniform draws come from
    ``kvsim/prng.py``, so a key gives the reference's bits.
  * top-k sparsification with error feedback — keeps the k largest-|g|
    entries per tensor (ties to the lower index, as ``jax.lax.top_k``) and
    carries the residual to the next step.

Keys are the port's threefry keys (``kvsim.prng.prng_key``, ``fold_in``,
``split``): pairs of 32-bit words, as ``jax.random.PRNGKey`` holds them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.kvsim import prng

__all__ = [
    "QuantGrad",
    "quantize_int8",
    "dequantize_int8",
    "TopKGrad",
    "topk_encode",
    "topk_decode",
    "ErrorFeedback",
]


class QuantGrad(NamedTuple):
    q: torch.Tensor  # int8 payload
    scale: torch.Tensor  # [] f32

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4


def quantize_int8(g: torch.Tensor, key: tuple | None = None, amax=None,
                  positions: torch.Tensor | None = None) -> QuantGrad:
    """Symmetric int8 with scale ``max|g| / 127``; with ``key``, stochastic
    rounding ``floor(x + u)`` with ``u`` the reference's uniform draw of
    ``g``'s shape, else round half to even. A block of a larger tensor (a
    mesh rank's) passes the whole tensor's ``amax`` and its elements' flat
    ``positions`` in it, so that the block gets the whole tensor's bits."""
    gf = g.float()
    scale = torch.clamp_min(gf.abs().max() if amax is None else amax, 1e-12) / 127.0
    x = gf / scale
    if key is not None:
        pos = torch.arange(x.numel(), device=x.device) if positions is None else positions.reshape(-1)
        u = prng.uniform(key, pos).reshape(x.shape)
        x = torch.floor(x + u)
    else:
        x = torch.round(x)
    return QuantGrad(q=torch.clamp(x, -127, 127).to(torch.int8), scale=scale)


def dequantize_int8(qg: QuantGrad) -> torch.Tensor:
    return qg.q.float() * qg.scale


class TopKGrad(NamedTuple):
    idx: torch.Tensor  # [k] int32 flat indices
    val: torch.Tensor  # [k] f32
    shape: tuple

    @property
    def nbytes(self) -> int:
        return self.idx.numel() * 4 + self.val.numel() * 4


def topk_encode(g: torch.Tensor, k: int) -> tuple[TopKGrad, torch.Tensor]:
    """Returns ``(sparse grad, residual to fold into error feedback)``."""
    gf = g.float().reshape(-1)
    k = min(k, gf.numel())
    idx = torch.sort(gf.abs(), descending=True, stable=True).indices[:k]
    picked = gf[idx]
    dense_kept = torch.zeros_like(gf).index_put((idx,), picked)
    residual = (gf - dense_kept).reshape(g.shape)
    return TopKGrad(idx=idx.to(torch.int32), val=picked, shape=tuple(g.shape)), residual


def topk_decode(tg: TopKGrad) -> torch.Tensor:
    out = torch.zeros(math.prod(tg.shape), dtype=torch.float32, device=tg.val.device)
    return out.index_put((tg.idx.long(),), tg.val).reshape(tg.shape)


class ErrorFeedback(NamedTuple):
    """Per-tensor residual memory for top-k (``init`` gives zeros like the
    grads)."""

    residual: dict

    @staticmethod
    def init(grads) -> "ErrorFeedback":
        return ErrorFeedback(residual=tree_lib.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads))

    def compress_step(self, grads, k: int):
        """grads + residual -> (sparse tree, new feedback)."""
        enc, res = [], []
        for g, r in zip(tree_lib.leaves(grads), tree_lib.leaves(self.residual)):
            e, nr = topk_encode(g.float() + r, k)
            enc.append(e)
            res.append(nr)
        return tree_lib.unflatten(grads, enc), ErrorFeedback(residual=tree_lib.unflatten(grads, res))
