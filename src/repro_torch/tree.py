"""Nested containers of tensors: the port's stand-in for ``jax.tree``.

Parameters, gradients and optimizer state are plain nested dicts and lists
(and NamedTuples) of tensors. Every function here visits dict keys in
sorted order, as ``jax.tree`` does, so leaf order matches the reference's
and a map may consume an iterator over ``leaves``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

Tree = Any
Path = Tuple[Any, ...]


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves_with_path(tree: Tree, path: Path = ()) -> Iterator[tuple]:
    """(path, leaf) in tree order; a path is the tuple of keys, indices and
    NamedTuple field names from the root."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], path + (k,))
    elif _is_namedtuple(tree):
        for k in tree._fields:
            yield from leaves_with_path(getattr(tree, k), path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Tree, path: Path = ()) -> Tree:
    """``fn(path, leaf)`` over the leaves of ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, k),
                                               path + (k,))
                            for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def path_str(path: Path) -> str:
    """Slash-joined path, the checkpoint's key for a leaf."""
    return "/".join(str(p) for p in path)
