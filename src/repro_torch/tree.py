"""Param trees as nested dicts and lists of tensors: mapping, and
flattening to the reference's key paths.

A path is the reference's ``jax.tree_util.keystr`` of a leaf, e.g.
``"['units']['b0']['attn']['wq']"`` or, under the remainder layers' list,
``"['rem'][0]['rec']['wx']"``; leaves come in the reference's flattening
order (dict keys sorted, list items in order), so a tree flattens to the
same sequence of (path, leaf) in both packages.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf of ``tree`` (None stays None) and to the
    matching nodes of ``rest``, which follow ``tree``'s structure; where
    ``tree`` has a leaf, the node of a tree in ``rest`` may be a subtree
    (AdamW's factored second moment keeps a {"row", "col"} dict there)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(tree, *rest)


def keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _children(tree) -> list:
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return list(enumerate(tree))


def flatten(tree, path: tuple = ()) -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in the reference's order (keys sorted)."""
    if isinstance(tree, (dict, list)):
        return [kv for k, v in _children(tree)
                for kv in flatten(v, path + (k,))]
    return [(keystr(path), tree)]


def map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(keystr path, leaf)`` over every leaf of a nested dict or
    list."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(keystr(path), tree)
