"""The single-device part of the distribution seam (counterpart of
``src/repro/dist.py``).

The models take a ``dist`` argument as the reference's do. This port runs on
one device, so ``dist=None`` is the only value it takes: ``constrain`` is a
no-op and ``embed_lookup`` a plain row gather. A mesh belongs to the
sharding slice and raises ``NotImplementedError``. ``unembed_logits`` is
the single-device LM head.
"""

from __future__ import annotations

import torch

__all__ = ["check_local", "constrain", "embed_lookup", "unembed_logits"]


def check_local(dist) -> None:
    """Raise unless ``dist`` is ``None`` or carries no mesh."""
    if dist is not None and getattr(dist, "mesh", None) is not None:
        raise NotImplementedError("a device mesh (dist.mesh) is not ported yet: sharding slice")


def constrain(x: torch.Tensor, dist, *spec) -> torch.Tensor:
    """The reference's sharding constraint; without a mesh, ``x`` itself."""
    check_local(dist)
    return x


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor, dist) -> torch.Tensor:
    """tokens ``[B, S]`` int -> rows ``[B, S, D]`` of ``table [V, D]``."""
    check_local(dist)
    return table[tokens.long()]


def unembed_logits(x: torch.Tensor, table: torch.Tensor, dist, vocab_size: int = 0) -> torch.Tensor:
    """``x [..., D] @ table.T`` -> f32 logits ``[..., V]``: bf16 products
    are exact in f32, so the product runs in f32 (the reference's
    ``preferred_element_type``). Rows at or past ``vocab_size`` (table
    padding) are set to -1e30 so samplers never pick them."""
    check_local(dist)
    logits = torch.matmul(x.float(), table.float().t())
    if vocab_size and vocab_size < table.shape[0]:
        logits[..., vocab_size:] = -1e30
    return logits
