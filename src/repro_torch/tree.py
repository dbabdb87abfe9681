"""Trees of tensors: the nested dicts and lists the port keeps parameters,
gradients and optimizer state in (the counterpart of ``jax.tree``).  Leaves
are visited in JAX's order: dict keys sorted, list items in order;
``None`` is an empty subtree.  A leaf's path is the tuple of its dict keys
(str) and list indices (int) from the root; :func:`keystr` writes it as
``jax.tree_util.keystr`` writes JAX's (``['layers'][0]['attn']``)."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [] if tree is None else [tree]


def unflatten(like, items):
    """``like``'s structure with its leaves taken in order from ``items``."""
    it = iter(items)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(like)


def map(fn, tree, *rest):  # noqa: A001 - the jax.tree.map counterpart
    """``fn`` applied leaf by leaf over trees of one structure."""
    return unflatten(tree, [fn(*xs) for xs in
                            zip(leaves(tree), *(leaves(r) for r in rest),
                                strict=True)])


def leaves_with_path(tree, path: tuple = ()) -> list:
    """[(path, leaf)] in JAX's flatten order."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_path(v, path + (i,))]
    return [] if tree is None else [(path, tree)]


def map_with_path(fn, tree, *rest):
    """``fn(path, leaf, *rest_leaves)`` leaf by leaf (the counterpart of
    ``jax.tree_util.tree_map_with_path``)."""
    return unflatten(tree, [fn(p, x, *xs) for (p, x), *xs in
                            zip(leaves_with_path(tree),
                                *(leaves(r) for r in rest), strict=True)])


def keystr(path) -> str:
    """``path`` as ``jax.tree_util.keystr`` writes a key path."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)
