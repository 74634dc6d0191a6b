"""Parameter trees: nested dicts, tuples and NamedTuples of tensors,
walked in insertion order (the port's counterpart of ``jax.tree``), and
their key paths as jax names them (``tree_flatten_with_path``,
``key_str``)."""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Tuple


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


class DictKey(NamedTuple):
    key: Any


class SequenceKey(NamedTuple):
    idx: int


class GetAttrKey(NamedTuple):
    name: str


def key_str(k) -> str:
    """Canonical string for one tree path entry (a copy of
    ``mxtpu/parallel/sharding.py``'s ``key_str``, over the entries of
    :func:`tree_flatten_with_path`, which mirror jax's key types)."""
    if hasattr(k, "key"):
        return str(k.key)
    if hasattr(k, "idx"):
        return str(k.idx)
    if hasattr(k, "name"):
        return str(k.name)
    return str(k)


def tree_flatten_with_path(tree: Any, prefix: Tuple = ()
                           ) -> List[Tuple[Tuple, Any]]:
    """``(path, leaf)`` for every leaf, as ``jax.tree_util
    .tree_flatten_with_path`` walks a tree: a dict by sorted key, a
    NamedTuple by field, a tuple or list by index, and ``None`` an empty
    subtree (no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k],
                                                prefix + (DictKey(k),))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f, v in zip(tree._fields, tree)
                for x in tree_flatten_with_path(v,
                                                prefix + (GetAttrKey(f),))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree)
                for x in tree_flatten_with_path(v,
                                                prefix + (SequenceKey(i),))]
    return [(prefix, tree)]


def path_str(path: Tuple) -> str:
    """A path of :func:`tree_flatten_with_path` as ``a/b/0``."""
    return "/".join(key_str(k) for k in path)


def tree_map_with_path(fn: Callable, tree: Any, prefix: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping its
    structure; paths are those of :func:`tree_flatten_with_path`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, prefix + (DictKey(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v,
                                               prefix + (GetAttrKey(f),))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map_with_path(fn, v, prefix + (SequenceKey(i),))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)
