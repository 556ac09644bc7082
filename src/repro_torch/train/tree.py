"""Nested dicts and lists of leaves, flattened as the reference's pytrees.

The reference's train state is a pytree: dicts (flattened in sorted key
order) and lists (in index order) of arrays.  Here the nodes are dicts
and lists; anything else, a tuple included, is a leaf.  The port keeps its
optimizer state and its checkpoints in the same tree, so a leaf's path
(``"opt/m/units/b0/attn/wq/w"``: dict keys and list indices joined by
``"/"``) and the order of the leaves are the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["at", "leaves", "tree_map", "tree_map_with_path", "unflatten"]


def leaves(tree: Any, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], f"{prefix}/{key}" if prefix else
                              str(key))
    elif isinstance(tree, list):
        for i, child in enumerate(tree):
            yield from leaves(child, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``, which must have ``tree``'s structure or extend it)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{prefix}/{k}" if prefix
                                      else str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, f"{prefix}/{i}" if prefix
                                   else str(i)) for i, v in enumerate(tree)]
    return fn(prefix, tree)


def at(tree: Any, path: str) -> Any:
    """The node of ``tree`` at ``path``."""
    for key in path.split("/") if path else ():
        tree = tree[int(key)] if isinstance(tree, list) else \
            tree[key]
    return tree


def unflatten(flat: dict[str, Any]) -> Any:
    """The tree whose leaves are ``flat`` (path -> leaf); a node whose
    keys are all indices 0..n-1 is a list."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        keys = path.split("/")
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = leaf

    def fix(node):
        if not isinstance(node, dict):
            return node
        node = {k: fix(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    return fix(root)
