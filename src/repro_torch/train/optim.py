"""AdamW, its schedule and gradient clipping (counterpart of
``src/repro/train/optim.py``).

The optimizer state mirrors the param tree: ``m`` and ``v`` are f32
whatever the param's dtype. Leaves are walked in the reference's tree order
(sorted dict keys, ``repro_torch.tree``), so ``global_norm`` adds the
leaves' sums in the same order. Unlike the reference's pure transform,
``apply_updates`` writes the new params, ``m`` and ``v`` into their tensors
in place (under ``torch.no_grad()``), so a training loop never rebuilds its
trees; it returns them all the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import tree as tree_lib

__all__ = ["OptConfig", "OptState", "init_opt", "apply_updates", "lr_at", "global_norm"]


class OptConfig(NamedTuple):
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    m: dict  # f32, like params
    v: dict  # f32, like params
    step: torch.Tensor  # [] int32


def init_opt(params) -> OptState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    dev = tree_lib.leaves(params)[0].device
    return OptState(m=tree_lib.tree_map(zeros, params), v=tree_lib.tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def lr_at(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac`` (f32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """The f32 L2 norm of every leaf together; the leaves' sums of squares
    are added in tree order."""
    total = 0
    for leaf in tree_lib.leaves(tree):
        total = total + leaf.float().square().sum()
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, state: OptState, gnorm=None):
    """One AdamW step: clip by the global norm, decoupled weight decay on
    leaves with ``ndim >= 2``. Writes the params, ``m`` and ``v`` in place;
    returns ``(params, OptState, metrics)`` with ``grad_norm`` and ``lr``.
    ``gnorm`` is the gradient's norm where the caller knows it (a mesh's
    blocks: ``global_norm`` of the local blocks is not it)."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1.0 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    for p, g, m, v in zip(tree_lib.leaves(params), tree_lib.leaves(grads), tree_lib.leaves(state.m),
                          tree_lib.leaves(state.v)):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, OptState(m=state.m, v=state.v, step=step), metrics
