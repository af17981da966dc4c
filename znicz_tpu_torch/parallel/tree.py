"""Pytrees of parameters: nested dicts and lists whose leaves are tensors,
arrays, shapes or specs (a tuple is a leaf).  Dicts are walked in their
keys' insertion order (``init_params``: ``emb``, ``head``, ``blocks``),
lists in index order; trees walked together are indexed by the first
one's keys."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other_leaves)`` over ``tree`` and the trees ``rest``
    of the same structure -> a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in walk order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_rebuild(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
