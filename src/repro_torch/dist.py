"""The single-device part of the distribution seam (counterpart of
``src/repro/dist.py``).

The models take a ``dist`` argument as the reference's do. This port runs on
one device, so ``dist=None`` is the only value it takes: ``constrain`` is a
no-op and ``embed_lookup`` a plain row gather. A mesh belongs to the
sharding slice and raises ``NotImplementedError``. ``unembed_logits`` is
the single-device LM head and ``softmax_xent`` the training loss over it,
chunked over tokens so that one chunk of logits is live at a time.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

__all__ = ["check_local", "constrain", "embed_lookup", "unembed_logits", "softmax_xent"]


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


def _xent_chunk(x, targets, mask, table, dist, vocab_size: int):
    """Sum of token losses and the masked-token count of one chunk: x ``[C,
    D]``, targets ``[C]`` int, mask ``[C]`` f32, ``table [V, D]`` f32.
    Logits past ``vocab_size`` are -1e30; the label logit is picked by a
    masked sum, as the reference picks it."""
    logits = torch.matmul(x.float(), table.t())
    v = logits.shape[-1]
    cols = torch.arange(v, device=logits.device)
    if vocab_size and vocab_size < v:
        logits = torch.where(cols >= vocab_size, -1e30, logits)
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[:, 0]
    onehot = cols[None, :] == targets[:, None]
    label = torch.where(onehot, logits, 0.0).sum(dim=-1)
    loss = (lse - label) * mask
    return loss.sum(), mask.sum()


def softmax_xent(x, table, targets, dist=None, mask=None, num_chunks: int = 8,
                 vocab_size: int = 0) -> torch.Tensor:
    """Mean cross-entropy over masked tokens: x ``[B, S, D]``, table ``[V,
    D]``, targets ``[B, S]``. The tokens are cut into ``num_chunks`` chunks
    (fewer where they do not divide); each chunk's logits are recomputed in
    the backward pass (``torch.utils.checkpoint``), so one chunk of logits
    is live at a time, as under the reference's ``jax.checkpoint``. The
    chunk sums add up in order in f32."""
    check_local(dist)
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    tf = targets.reshape(t)
    mf = torch.ones(t, dtype=torch.float32, device=x.device) if mask is None \
        else mask.reshape(t).to(torch.float32)
    num_chunks = min(num_chunks, t)
    while t % num_chunks:
        num_chunks -= 1
    c = t // num_chunks
    table_f = table.float()  # once a call; the chunks read it
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(num_chunks):
        rows = slice(i * c, (i + 1) * c)
        l, n = torch.utils.checkpoint.checkpoint(
            _xent_chunk, xf[rows], tf[rows], mf[rows], table_f, dist, vocab_size,
            use_reentrant=False)
        tot, cnt = tot + l, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)
