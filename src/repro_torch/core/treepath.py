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
