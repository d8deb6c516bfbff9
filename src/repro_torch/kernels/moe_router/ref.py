"""Plain PyTorch version of the MoE router (counterpart of
``src/repro/kernels/moe_router/ref.py``, which matches ``_top_k_gates`` and
the count fold of ``src/repro/models/moe.py``): the yardstick the CUDA
kernel in ``csrc/moe_router.cu`` is held to, and what the wrapper runs for
tensors on the CPU.

Softmax as ``jax.nn.softmax`` forms it (``exp(x - max) / sum``), then the
top k by k rounds of first-index argmax and mask, which orders ties by the
lower expert id as ``jax.lax.top_k`` does (``torch.topk`` promises no
order among ties).
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "router_ref"]

NEG_INF = -1e30  # the mask value of the reference kernel


def router_ref(logits: torch.Tensor, k: int, group: int):
    """logits ``[T, E]`` -> ``(gates [T, K] f32, ids [T, K] int32,
    counts [ceil(T / group), E] f32)``: gates renormalised over the k picks,
    and the picks per expert counted within each group of ``group``
    consecutive rows (the last group may be short)."""
    t, e = logits.shape
    x = logits.to(torch.float32)
    p = torch.exp(x - x.amax(dim=-1, keepdim=True))
    masked = p / p.sum(dim=-1, keepdim=True)
    vals, ids = [], []
    for _ in range(k):
        a = masked.argmax(dim=-1, keepdim=True)  # first index of the maximum
        vals.append(masked.gather(-1, a))
        ids.append(a)
        masked = masked.scatter(-1, a, NEG_INF)
    vals = torch.cat(vals, dim=-1)
    ids = torch.cat(ids, dim=-1)
    gates = vals / torch.clamp_min(vals.sum(dim=-1, keepdim=True), 1e-9)
    ng = -(-t // group)
    rows = torch.arange(t, device=logits.device) // group
    counts = torch.zeros(ng * e, dtype=torch.float32, device=logits.device)
    flat = (rows[:, None] * e + ids).reshape(-1)
    counts.index_add_(0, flat, torch.ones(flat.shape, dtype=torch.float32, device=logits.device))
    return gates, ids.to(torch.int32), counts.reshape(ng, e)
