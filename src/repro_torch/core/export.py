"""Language-agnostic weight serialization — the paper's Avro analogue.

The paper exports trained PyTorch weights via an Avro schema: every tensor is
flattened to one dimension with its dims saved as metadata, then restored on
the Java side. This module implements the same record layout natively:

  MAGIC | u64 header_len | JSON header | concatenated raw buffers

Header: {"schema_version", "model", "meta", "tensors": [{name, dtype, shape,
offset, nbytes}]}. Buffers are little-endian C-order — readable from any
language with a JSON parser (the interoperability property Avro provided).
The byte layout is the one the JAX package writes, so a blob written by
either package loads in the other. Parameter trees are nested dicts and
lists of ``torch.Tensor`` or numpy arrays; tensor names are their
'/'-joined key paths (``core.treepath.keystr``), list items by index
(``bot/w/0``), as JAX names the items of a pytree's lists.
"""
from __future__ import annotations

import io
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.treepath import keystr

MAGIC = b"RPROAVRO1\n"
SCHEMA_VERSION = 1


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _walk(item, path + (i,))
    else:
        yield path, tree


def flatten_named(params) -> Dict[str, np.ndarray]:
    """A parameter tree as ``{"conv_q/w": array, ...}`` (numpy, on the host)."""
    return {keystr(path): _to_numpy(leaf) for path, leaf in _walk(params)}


def _lists(node):
    """Dicts whose keys are exactly "0" .. "n-1" become lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and sorted(node) == sorted(str(i) for i in range(len(node))):
        return [node[str(i)] for i in range(len(node))]
    return node


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """Inverse of ``flatten_named``: ``"conv_q/w"`` -> ``{"conv_q": {"w":
    ...}}``, and ``"bot/w/0"``, ``"bot/w/1"`` -> ``{"bot": {"w": [..., ...]}}``."""
    out: Dict = {}
    for name, arr in flat.items():
        node = out
        *heads, last = name.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    return _lists(out)


def to_torch(tree, device="cuda"):
    """A parameter tree of numpy arrays (the JAX package's, or ``unflatten``
    of ``loads``), or of tensors, as contiguous tensors of the same dtype on
    ``device``, with the same nesting (lists and tuples become lists).
    bfloat16 arrays (``ml_dtypes``, as ``np.asarray`` gives them for JAX's
    bfloat16) stay bfloat16."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, dev) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(dev).contiguous()
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":   # numpy's own types have no bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C")).to(dev)


def dumps(params: Any, model: str = "", meta: Optional[Dict] = None) -> bytes:
    """Serialize a params tree (or a {name: array} dict) to bytes."""
    flat = flatten_named(params)
    tensors, buf = [], io.BytesIO()
    offset = 0
    for name in sorted(flat):
        arr = flat[name]
        shape = list(arr.shape)  # before ascontiguousarray (it 1-d-ifies 0-d)
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        tensors.append({"name": name, "dtype": str(arr.dtype),
                        "shape": shape, "offset": offset,
                        "nbytes": len(raw)})
        buf.write(raw)
        offset += len(raw)
    header = json.dumps({"schema_version": SCHEMA_VERSION, "model": model,
                         "meta": meta or {}, "tensors": tensors}).encode()
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(len(header).to_bytes(8, "little"))
    out.write(header)
    out.write(buf.getvalue())
    return out.getvalue()


def loads(data: bytes) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Parse bytes -> ({name: np.ndarray}, header). Pure numpy."""
    if not data.startswith(MAGIC):
        raise ValueError("bad magic: not a repro export file")
    hlen = int.from_bytes(data[len(MAGIC):len(MAGIC) + 8], "little")
    hstart = len(MAGIC) + 8
    header = json.loads(data[hstart:hstart + hlen])
    if header["schema_version"] != SCHEMA_VERSION:
        raise ValueError(f"schema_version {header['schema_version']} != {SCHEMA_VERSION}")
    body = hstart + hlen
    out = {}
    for t in header["tensors"]:
        raw = data[body + t["offset"]: body + t["offset"] + t["nbytes"]]
        out[t["name"]] = np.frombuffer(raw, dtype=np.dtype(t["dtype"])
                                       ).reshape(t["shape"]).copy()
    return out, header
