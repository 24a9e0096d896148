"""Helpers for nested dicts, lists and tuples of tensors (the port's
pytrees), used by checkpointing and tests.

Paths and leaf order are the JAX package's (``jax.tree_util``): dict keys
sorted, sequences in order, namedtuple fields by name, ``None`` an empty
subtree; a path joins its keys with ``/`` (``"a/b/0"``). A checkpoint keys
its leaves by these paths, so one written by either package restores in
the other.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> list[tuple[str, Any]] | None:
    """``[(key, child), ...]`` of an inner node in the JAX package's order,
    or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def tree_flatten_with_paths(tree: Any) -> list[tuple[str, Any]]:
    """Flatten a tree into ``[("a/b/0", leaf), ...]`` with stable paths."""
    out: list[tuple[str, Any]] = []
    _flatten(tree, (), out)
    return out


# The walks are module functions, not closures that call themselves: such
# a closure is a reference cycle holding what it captured (the leaves, a
# train step's gradients) until the garbage collector runs.
def _flatten(node: Any, prefix: tuple[str, ...], out: list) -> None:
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append(("/".join(prefix), node))
        return
    for key, child in kids:
        _flatten(child, prefix + (key,), out)


def tree_map_with_paths(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """The same nesting with every leaf replaced by ``fn(path, leaf)``."""
    return _map(fn, tree, ())


def _map(fn: Callable[[str, Any], Any], node: Any, prefix: tuple[str, ...]) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map(fn, node[k], prefix + (str(k),)) for k in node}
    if _is_namedtuple(node):
        return type(node)(*(_map(fn, getattr(node, f), prefix + (f,)) for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_map(fn, v, prefix + (str(i),)) for i, v in enumerate(node))
    return fn("/".join(prefix), node)


def _leaves(tree: Any) -> list:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_count(tree: Any) -> int:
    """Total number of elements in the tree."""
    return sum(int(np.prod(tuple(x.shape))) for x in _leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total number of bytes in the tree's tensors."""
    return sum(x.numel() * x.element_size() for x in _leaves(tree))


def tree_zeros_like(tree: Any) -> Any:
    return tree_map_with_paths(lambda _, x: torch.zeros_like(x), tree)
