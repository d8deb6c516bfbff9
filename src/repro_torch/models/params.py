"""Declarative parameters (counterpart of ``src/repro/models/params.py``).

Every parameter is declared once as a :class:`ParamSpec`: shape, logical
axis names (one a dim, ``None`` for a dim no rule shards), init and dtype.
From that one declaration come

  * ``init_params``      — tensors, a tree of the specs' structure (nested
    dicts and lists), so a reference params tree carries across one to one
    (``interop.params_from_numpy``);
  * ``abstract_params``  — the same tree as ``meta`` tensors (the dry run;
    nothing is allocated);
  * ``partition_specs``  — per dim, the mesh axes a dim is split over, by
    logical-to-mesh rules (``launch/sharding.param_rules``).

Logical axes used by the models: layers, vocab, embed, embed_rep, heads,
kv_heads, head_dim, mlp, experts, expert_mlp, state.

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
           "abstract_params", "partition_specs", "count_params"]

Init = Callable[[torch.Generator, tuple, torch.dtype, torch.device], torch.Tensor]


class ParamSpec(NamedTuple):
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name a dim (None = replicated)
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


def abstract_params(specs):
    """The tree of ``meta`` tensors of the specs' shapes and dtypes: a dry
    run's params, never allocated."""
    return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def partition_specs(specs, rules: dict):
    """Logical axes -> a tuple a leaf of mesh-axis entries (a mesh axis, a
    tuple of them, or ``None``), one a dim, by ``rules`` (logical name ->
    entry). An unknown logical name raises ``KeyError``: sharding is a
    decision taken for every axis."""

    def one(s: ParamSpec) -> tuple:
        parts = []
        for ax in s.axes:
            if ax is None:
                parts.append(None)
            elif ax in rules:
                parts.append(rules[ax])
            else:
                raise KeyError(f"no sharding rule for logical axis {ax!r}")
        return tuple(parts)

    return map_specs(one, specs)


def map_specs(fn, specs):
    """``fn`` of every ``ParamSpec`` of a tree, in a tree of the same
    structure."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    if isinstance(specs, dict):
        return {key: map_specs(fn, val) for key, val in specs.items()}
    return [map_specs(fn, val) for val in specs]


def count_params(specs) -> int:
    """The number of parameters a ``ParamSpec`` tree declares."""
    return sum(math.prod(spec.shape) for _, spec in _leaves(specs))
