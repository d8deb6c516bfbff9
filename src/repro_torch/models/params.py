"""Declarative parameters (counterpart of ``src/repro/models/params.py``).

Every parameter is declared once as a :class:`ParamSpec` (shape, init,
dtype); ``init_params`` materialises a tree of specs (nested dicts and lists) into
tensors with the same structure, so a reference params tree carries across one to one
(``interop.params_from_numpy``). The reference's logical axes and partition
specs belong to the sharding slice and are not carried.

Draws come from one explicit ``torch.Generator``, leaf by leaf in
``jax.tree``'s order (dict keys sorted, lists by index): the same
distributions as the reference, not its bits.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device

__all__ = ["ParamSpec", "dense_init", "embed_init", "zeros_init", "ones_init", "init_params",
           "count_params"]

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


def zeros_init(gen, shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(gen, shape, dtype, device):
    return torch.ones(shape, dtype=dtype, device=device)


def _leaves(specs, prefix=()):
    """``(path, spec)`` pairs in ``jax.tree``'s order: a dict's entries by
    sorted key, a list's by index."""
    if isinstance(specs, ParamSpec):
        yield prefix, specs
    elif isinstance(specs, dict):
        for key in sorted(specs):
            yield from _leaves(specs[key], prefix + (key,))
    else:
        for i, val in enumerate(specs):
            yield from _leaves(val, prefix + (i,))


def init_params(specs, gen: torch.Generator, device=None):
    """Materialise a ``ParamSpec``, or a tree of them (dicts and lists, as
    rglru's per-layer lists), on ``device`` (``None`` means CUDA), leaf by
    leaf in ``jax.tree``'s order. ``gen`` must live on that device."""
    device = resolve_device(device)
    if isinstance(specs, ParamSpec):
        return specs.init(gen, specs.shape, specs.dtype, device)
    if isinstance(specs, dict):
        built = {key: init_params(specs[key], gen, device) for key in sorted(specs)}
        return {key: built[key] for key in specs}
    return [init_params(val, gen, device) for val in specs]


def count_params(specs) -> int:
    """The number of parameters a ``ParamSpec`` tree declares."""
    return sum(math.prod(spec.shape) for _, spec in _leaves(specs))
