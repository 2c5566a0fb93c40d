"""Trees of tensors (nested dicts, lists and tuples): the port's stand-in
for ``jax.tree``.

The reference package's parameter, optimizer-state and batch trees are
nested dicts, the encoder-decoder and the xLSTM keep their blocks in lists,
and the recurrent caches hold tuples (an sLSTM's ``(h, c, n, m)``, an
mLSTM's ``(S, n)``). ``jax.tree_util`` walks a dict in SORTED key order and
a list or tuple in index order, and the order matters beyond style: the
optimizer's global norm sums its leaves in that order, and a checkpoint
names, groups and writes its leaves in it. So :func:`tree_flatten` walks
them as JAX does, a list or tuple item's path entry being its index (an
``int``; ``"/".join(map(str, path))`` gives the reference checkpoint's leaf
name, ``params/decoder/0/cross_attn/wq``). ``None`` is an empty subtree, as
in ``jax.tree_util`` (a Mamba2 conv buffer after a prompt shorter than the
conv's reach): it holds no leaf, ``tree_map`` keeps it and
``tree_unflatten`` rebuilds it. Anything else that is neither a dict, a list
nor a tuple is a leaf.
"""

from __future__ import annotations

_SEQUENCES = (list, tuple)


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf over ``tree`` and trees of its structure;
    lists stay lists and tuples tuples, ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, _SEQUENCES):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def _children(node) -> list:
    """[(path entry, child)] of a dict (keys sorted) or a list or tuple (in
    order)."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    return list(enumerate(node))


def tree_flatten(tree) -> list[tuple[tuple[str | int, ...], object]]:
    """[(path, leaf)] in JAX's order: dict keys sorted, list and tuple items
    in order, depth first; nothing for a ``None``."""
    if tree is None:
        return []
    if not isinstance(tree, (dict, *_SEQUENCES)):
        return [((), tree)]
    return [((k, *path), leaf) for k, child in _children(tree)
            for path, leaf in tree_flatten(child)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_flatten`'s order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, _SEQUENCES):
            return type(node)(build(child) for child in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
