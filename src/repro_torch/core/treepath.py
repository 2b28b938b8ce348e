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


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of ``tree``, keeping the nesting
    (dicts, lists and tuples stay what they were); ``path`` holds the dict
    keys and item indices down to the leaf, as ``keystr`` renders them
    (``jax.tree_util.tree_map_with_path``'s paths)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
        return items if isinstance(tree, list) else tuple(items)
    return fn(path, tree)


def tree_paths(tree) -> list:
    """``[(path, leaf), ...]`` in the tree's own order (dict keys as
    inserted), on ``tree_map_with_path``'s walk."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree)
    return out
