"""The one walker over the port's state trees (nested dicts, tuples, lists
of tensors): parameters, optimizer state, train state, checkpoints.

:func:`named_leaves` and :func:`tree_map` visit leaves in the same order
(insertion order of dicts, index order of sequences), so a flat list of
leaves or paths lines up with the tree it came from.  A leaf's path is its
keys and indices joined by ``/``, the checkpoint's array names.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

__all__ = ["named_leaves", "tree_leaves", "tree_map"]


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """``(path, leaf)`` over ``tree``, in :func:`tree_map`'s order."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (tuple, list)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from named_leaves(v, f"{prefix}/{k}" if prefix else k)


def tree_leaves(tree) -> List:
    """The leaves of ``tree``, in :func:`tree_map`'s order."""
    return [leaf for _, leaf in named_leaves(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and of same-structure ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
