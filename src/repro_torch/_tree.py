"""The port's trees of tensors: tensors (the leaves), tuples, lists, dicts,
named tuples, and the registered types, as ``repro``'s pytrees flatten them
(a dict by sorted key, a named tuple by field, a sequence by position, a
:class:`~repro_torch.pack.PackedArray` as its payload and splits, a
:class:`~repro_torch.precision.SiteTracker` as its RangeTracker). None holds
no leaf. ``repro_torch.ckpt`` names a checkpoint's files by these paths."""

from __future__ import annotations

from repro_torch.pack import PackedArray
from repro_torch.precision.sites import SiteTracker

__all__ = ["children", "flatten", "unflatten", "tree_map"]


def children(tree):
    """``(keys, children, rebuild)`` of an inner node, or None for a leaf
    (and for None)."""
    if isinstance(tree, PackedArray):
        return ["0", "1"], [tree.payload, tree.k], lambda c: PackedArray(c[0], c[1], tree.fmt, tree.shape, tree.block)
    if isinstance(tree, SiteTracker):
        return ["0"], [tree.state], lambda c: tree.with_state(c[0])
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(tree._fields), list(tree), lambda c: type(tree)(*c)
    if isinstance(tree, (tuple, list)):
        return [f"idx{i}" for i in range(len(tree))], list(tree), lambda c: type(tree)(c)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return [str(k) for k in keys], [tree[k] for k in keys], lambda c: dict(zip(keys, c))
    return None


def flatten(tree, prefix=()):
    """Each leaf with its path, the keys from the root, in ``repro``'s order."""
    if tree is None:
        return []
    node = children(tree)
    if node is None:
        return [(prefix, tree)]
    keys, kids, _ = node
    return [item for key, kid in zip(keys, kids) for item in flatten(kid, prefix + (key,))]


def unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the iterator ``leaves``."""
    if like is None:
        return None
    node = children(like)
    if node is None:
        return next(leaves)
    _, kids, rebuild = node
    return rebuild([unflatten(kid, leaves) for kid in kids])


def tree_map(fn, tree):
    """``fn`` over every leaf of ``tree``, the structure kept."""
    return unflatten(tree, iter([fn(leaf) for _, leaf in flatten(tree)]))
