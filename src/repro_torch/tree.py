"""The pytree operations the training modules need, in ``jax.tree``'s order.

The reference walks its trees with ``jax.tree`` (``flatten``,
``tree_flatten_with_path``): a dict's leaves in sorted key order, a
NamedTuple's in field order, a list's or tuple's in index order, ``None``
as an empty subtree. The int8 key split, ``global_norm``'s sum and the
checkpoint leaf names follow that order, so the port walks its trees the
same way. A path entry is ``("key", k)`` for a dict key, ``("attr",
name)`` for a NamedTuple field and ``("idx", i)`` for a sequence index.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["leaves_with_paths", "leaves", "unflatten", "tree_map"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves_with_paths(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += leaves_with_paths(tree[key], prefix + (("key", key),))
        return out
    if _is_namedtuple(tree):
        out = []
        for name in tree._fields:
            out += leaves_with_paths(getattr(tree, name), prefix + (("attr", name),))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, val in enumerate(tree):
            out += leaves_with_paths(val, prefix + (("idx", i),))
        return out
    return [(prefix, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` (in ``jax.tree``'s
    order) in place of its leaves."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {key: build(node[key]) for key in sorted(node)}
            return {key: built[key] for key in node}  # the template's own key order
        if _is_namedtuple(node):
            return type(node)(*(build(getattr(node, name)) for name in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(val) for val in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others)) for i, leaf in enumerate(leaves(tree))])
