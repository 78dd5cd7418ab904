"""Nested-dict trees of tensors, flattened in the reference's order.

``jax.tree`` flattens a dict by its sorted keys; the gradient exchange
reseeds each leaf by its index in that order and the checkpoint names each
array by its path, so the port flattens the same way. Leaves are anything
that is not a dict.
"""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> list:
    """[(path, leaf)] with dict keys sorted, paths joined by "."."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(flatten(tree[k], f"{prefix}.{k}" if prefix else str(k)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(pairs) -> dict:
    """The inverse of ``flatten``: [(path, leaf)] -> nested dict."""
    out: dict = {}
    for path, leaf in pairs:
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over matching leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
