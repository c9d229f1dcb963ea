"""Nested containers of tensors: the port's stand-in for JAX pytrees.

A tree is a dataclass instance (its fields, in declaration order), a dict
(its keys, sorted), a list or a tuple, or None (no leaves); anything else
is a leaf, and so is a tuple whose type sets ``_tree_leaf`` (a
``PartitionSpec``).  That is the order and the key naming of
``jax.tree_util.tree_flatten_with_path`` for the reference's registered
dataclasses, dicts and sequences, so ``path_leaves`` names a leaf by the
same "/"-joined path in both packages (``params/w``, ``opt_state/m/w``):
the keys of a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple


def _children(tree) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of a container, or None for a leaf."""
    if getattr(tree, "_tree_leaf", False):
        return None
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(tree, keys, values):
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **dict(zip(keys, values)))
    if isinstance(tree, dict):
        return dict(zip(keys, values))
    if hasattr(tree, "_fields"):                  # a NamedTuple
        return type(tree)(*values)
    return type(tree)(values)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf-wise over ``tree`` and trees of its structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    rest_kids = [_children(r) for r in rest]
    values = [tree_map(fn, child, *(rk[i][1] for rk in rest_kids))
              for i, (_, child) in enumerate(kids)]
    return _rebuild(tree, [k for k, _ in kids], values)


def path_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in flattening order; paths join keys by "/"."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += path_leaves(child, f"{prefix}/{key}" if prefix else str(key))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in path_leaves(tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``fn(path, leaf)`` applied leaf-wise, keeping the structure."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    values = [map_with_path(fn, child, f"{prefix}/{key}" if prefix else str(key))
              for key, child in kids]
    return _rebuild(tree, [k for k, _ in kids], values)


def unflatten_like(tree, leaves: list):
    """A tree of ``tree``'s structure holding ``leaves`` in flattening order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
