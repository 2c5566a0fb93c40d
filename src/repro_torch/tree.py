"""Nested-dict trees of tensors: the port's stand-in for ``jax.tree``.

The reference package's parameter, optimizer-state and batch trees are
nested dicts. ``jax.tree_util`` walks a dict in SORTED key order, and the
order matters beyond style: the optimizer's global norm sums its leaves in
that order, and a checkpoint names, groups and writes its leaves in it. So
:func:`tree_flatten` sorts keys as JAX does; anything that is not a dict is
a leaf.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_flatten(tree) -> list[tuple[tuple[str, ...], object]]:
    """[(key path, leaf)] in JAX's order: dict keys sorted, depth first."""
    if not isinstance(tree, dict):
        return [((), tree)]
    return [((k, *path), leaf) for k in sorted(tree) for path, leaf in tree_flatten(tree[k])]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_flatten`'s order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
