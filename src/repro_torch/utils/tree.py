"""Nested dicts of tensors (the port's pytrees): map, leaves and paths.

Keys are visited in sorted order, which is the order in which
``jax.tree_util`` flattens a dict, so leaves line up with the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_items(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """("a/b/c", leaf) pairs in flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], f"{path}/{k}" if path else str(k))
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_items(tree)]
