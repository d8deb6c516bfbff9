"""The import guard: no module of JAX or of the JAX package may be loaded
by a run of the benchmark. Names are compared by their top-level part
whole (the part before the first dot), so ``repro_torch`` is not
``repro``."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_modules"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names=None) -> list[str]:
    """The loaded module names (``sys.modules`` by default) whose top-level
    name is forbidden, sorted."""
    names = sys.modules if names is None else names
    return sorted(name for name in names if name.partition(".")[0] in FORBIDDEN)
