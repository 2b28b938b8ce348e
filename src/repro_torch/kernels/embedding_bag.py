"""EmbeddingBag over fixed-arity bags: every DLRM embedding lookup.

  out[b] = sum_l weights[b, l] * table[ids[b, l]]     ids (B, L) -> (B, d)

summed in float32 in order l = 0 .. L-1 and written in the table's type;
``weights=None`` means every weight is 1.

``embedding_bag`` is the wrapper the model calls. A CUDA tensor goes to the
hand-written Hopper kernel in ``csrc/embedding_bag.cu`` (the port of the TPU
kernel ``src/repro/kernels/embedding_bag.py:45``), built on first use and
bound with ``ctypes``; a CPU tensor goes to ``embedding_bag_plain``, the
plain PyTorch version of the same function. There is no other route: a CUDA
call launches the kernel or raises. ``weights=None`` reaches the kernel as a
null pointer, not as a tensor of ones.

Ids follow the JAX package's ``jnp.take``: an id in ``[-V, 0)`` names row
``id + V``, and an id outside ``[-V, V)`` makes its whole bag NaN. Both
routes do this, and neither reads outside the table.

``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel; ``reset_launches`` sets it to 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

#: TPU kernel this replaces (file:line of its wrapper; body ``_kernel`` at
#: :26, ``pallas_call`` at :56)
REPLACES = "src/repro/kernels/embedding_bag.py:45"
SOURCE = "src/repro_torch/kernels/csrc/embedding_bag.cu"
#: the kernel reads a row in slices of this many elements (one 8- or
#: 16-byte load a lane), so it takes a width d that is a multiple of it;
#: the plain version takes any width
KERNEL_VEC = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def embedding_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """take + weighted sum over the bag axis, the port of the JAX package's
    oracle ``ref.embedding_bag_ref``: the rows in float32, times the
    weights, summed in float32 in order l = 0 .. L-1 (the kernel's order,
    so the two agree bit for bit), cast to the table's type. Ids index as
    ``jnp.take`` does: ``[-V, 0)`` wraps, and a bag holding an id outside
    ``[-V, V)`` is NaN."""
    v = table.shape[0]
    idx = ids.long()
    idx = torch.where(idx < 0, idx + v, idx)
    outside = ((idx < 0) | (idx >= v)).any(dim=1, keepdim=True)   # (B, 1)
    rows = table[idx.clamp(0, v - 1)].float()         # (B, L, d)
    if weights is not None:
        rows = rows * weights.float()[..., None]
    out = torch.zeros((ids.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for l in range(ids.shape[1]):
        out = out + rows[:, l]
    return out.masked_fill(outside, float("nan")).to(table.dtype)


def _check(table: torch.Tensor, ids: torch.Tensor,
           weights: Optional[torch.Tensor]) -> None:
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"table must be (V, d) and ids (B, L); got "
                         f"{tuple(table.shape)}, {tuple(ids.shape)}")
    if table.dtype not in _DTYPE_CODES:
        raise TypeError(f"table dtype {table.dtype} not supported (float32 or bfloat16)")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, not {ids.dtype}")
    if weights is not None:
        if tuple(weights.shape) != tuple(ids.shape):
            raise ValueError(f"weights must be (B, L) = {tuple(ids.shape)}, "
                             f"not {tuple(weights.shape)}")
        if not weights.is_floating_point():
            raise TypeError(f"weights must be floating point, not {weights.dtype}")
        if weights.device != ids.device:
            raise ValueError(f"devices differ: ids {ids.device}, weights {weights.device}")
    if table.device != ids.device:
        raise ValueError(f"devices differ: table {table.device}, ids {ids.device}")
    if not table.is_contiguous() or not ids.is_contiguous():
        raise ValueError("table and ids must be contiguous")
    if ids.shape[0] == 0 or table.shape[0] == 0 or table.shape[1] == 0:
        raise ValueError(f"empty input: table {tuple(table.shape)}, ids {tuple(ids.shape)}")


def _kernel_fn():
    fn = build.load_library("embedding_bag").embedding_bag_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(table: torch.Tensor, ids: torch.Tensor,
            weights: Optional[torch.Tensor]) -> torch.Tensor:
    v, d = table.shape
    b, l = ids.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    err = _kernel_fn()(_DTYPE_CODES[table.dtype], table.data_ptr(), v, d,
                       ids.data_ptr(), None if weights is None else weights.data_ptr(),
                       out.data_ptr(), b, l, stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: CUDA error {err} "
                           f"at V={v} d={d} B={b} L={l} {table.dtype}")
    return out


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table (V, d), ids (B, L) int32, weights (B, L) or None -> (B, d) in
    the table's type: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors."""
    global launches
    _check(table, ids, weights)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, weights)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    if table.shape[1] % KERNEL_VEC:
        raise ValueError(f"the CUDA kernel is compiled for widths that are a "
                         f"multiple of {KERNEL_VEC}, not {table.shape[1]}")
    if table.data_ptr() % 16:
        raise ValueError("table must start on a 16-byte boundary")
    if weights is not None:
        weights = weights.float().contiguous()
    index = table.device.index
    if index is None or index == torch.cuda.current_device():
        out = _launch(table, ids, weights)
    else:   # the kernel launches on the runtime's current device
        with torch.cuda.device(index):
            out = _launch(table, ids, weights)
    launches += 1
    return out
