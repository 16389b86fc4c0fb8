"""Nested dicts and lists of tensors (a parameter or training state tree),
walked the way ``jax.tree_util`` walks the reference's: dict keys in sorted
order, list and tuple items in order, anything else a leaf."""

from __future__ import annotations

from typing import Any, Callable, Iterator


def _children(tree) -> Iterator[tuple[Any, Any]]:
    if isinstance(tree, dict):
        return ((k, tree[k]) for k in sorted(tree))
    return enumerate(tree)


def is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves(tree) -> list:
    if not is_node(tree):
        return [tree]
    return [leaf for _, child in _children(tree) for leaf in leaves(child)]


def map(fn: Callable, tree, *rest):
    """The tree of ``fn(leaf, *matching leaves of rest)``, of ``tree``'s
    shape; ``fn`` meets the leaves in the order of ``leaves``."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten(tree, new_leaves: list):
    """``tree``'s shape with ``new_leaves`` (in the order of ``leaves``)."""
    it = iter(new_leaves)
    return map(lambda _: next(it), tree)


def with_paths(tree, prefix: str = "") -> dict[str, Any]:
    """``{path: leaf}`` with paths of "/"-joined dict keys and list indices,
    as the reference's checkpoint keys print them (``params/segments/0/0/...``)."""
    if not is_node(tree):
        return {prefix: tree}
    out: dict[str, Any] = {}
    for k, child in _children(tree):
        out.update(with_paths(child, f"{prefix}/{k}" if prefix else str(k)))
    return out
