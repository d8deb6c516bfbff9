"""Declarative parameters (counterpart of ``src/repro/models/params.py``).

Every parameter is declared once as a :class:`ParamSpec` (shape, init,
dtype); ``init_params`` materialises a nested dict of specs into tensors
with the same keys, so a reference params tree carries across one to one
(``interop.params_from_numpy``). The reference's logical axes and partition
specs belong to the sharding slice and are not carried.

Draws come from one explicit ``torch.Generator``, leaf by leaf in sorted key
order: the same distributions as the reference, not its bits.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = ["ParamSpec", "dense_init", "embed_init", "init_params"]

Init = Callable[[torch.Generator, tuple, torch.dtype, torch.device], torch.Tensor]


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    init: Init
    dtype: torch.dtype = torch.bfloat16


def dense_init(fan_in: int, scale: float = 1.0) -> Init:
    """Truncated normal on [-3, 3] standard deviations, std
    ``scale / sqrt(fan_in)``, drawn in f32 and stored in the spec's dtype."""

    def f(gen, shape, dtype, device):
        std = scale / math.sqrt(max(fan_in, 1))
        w = torch.empty(shape, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=gen)
        return (w * std).to(dtype)

    return f


def embed_init(scale: float = 1.0) -> Init:
    def f(gen, shape, dtype, device):
        w = torch.randn(shape, dtype=torch.float32, device=device, generator=gen)
        return (w * scale).to(dtype)

    return f


def _leaves(specs, prefix=()):
    if isinstance(specs, ParamSpec):
        yield prefix, specs
        return
    for key in sorted(specs):
        yield from _leaves(specs[key], prefix + (key,))


def init_params(specs, gen: torch.Generator, device=None) -> dict:
    """Materialise a ``ParamSpec``, or a nested dict of them, on ``device``
    (``None`` means CUDA). ``gen`` must live on that device."""
    device = resolve_device(device)
    if isinstance(specs, ParamSpec):
        return specs.init(gen, specs.shape, specs.dtype, device)
    out: dict = {}
    for path, spec in _leaves(specs):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = spec.init(gen, spec.shape, spec.dtype, device)
    return out

