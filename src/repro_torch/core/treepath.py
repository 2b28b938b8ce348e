"""Key-path rendering for nested parameter trees.

Exported tensor names ("conv_q/w", "layers/0/w") are the '/'-joined key
path of a tensor in its parameter tree. Both packages render names with
this rule, so weights cross between them by name.
"""
from __future__ import annotations


def keystr(path) -> str:
    """Render a key path (dict keys, sequence indices or attribute entries)
    as "a/0/w"."""
    parts = []
    for entry in path:
        for attr in ("key", "idx", "name"):  # DictKey / SequenceKey / GetAttrKey
            if hasattr(entry, attr):
                parts.append(str(getattr(entry, attr)))
                break
        else:
            parts.append(str(entry).strip("[].'\""))
    return "/".join(parts)


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts and lists, in the JAX package's
    order (``jax.tree.leaves``: dict keys sorted, list items in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of the
    trees in ``rest``), keeping the nesting: a new tree, nothing mutated."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, item, *(r[i] for r in rest))
                for i, item in enumerate(tree)]
    return fn(tree, *rest)
