"""EmbeddingBag over fixed-arity bags, forward and gradient: every DLRM
embedding lookup and its training update.

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

The gradient. Where grad is enabled and the table requires it,
``embedding_bag`` goes through ``EmbeddingBag`` (a
``torch.autograd.Function``), whose backward is ``embedding_bag_bwd``: the
dense (V, d) table gradient, row r the sum of ``w[b, l] * grad_out[b]`` over
the positions naming r, in the table's type, a row no id names 0. On CUDA
tensors it is the hand-written kernel of ``csrc/embedding_bag_bwd.cu`` (a
library of its own); on CPU tensors ``embedding_bag_bwd_plain``. The JAX
twin is the VJP of ``jnp.take`` (``src/repro/models/recsys.py:44``), with
its indexing: ``[-V, 0)`` wraps, and an id outside ``[-V, V)`` adds nothing.
Unlike that VJP, which sums a bfloat16 table's gradient in bfloat16 (3000
ones on one row give 256; ROADMAP.md §3, reference fault 8), every sum here
is float32, rounded once. The weights get no gradient: a ``weights`` that
requires one raises.

On ``meta`` tensors (the dry-run planner's) the wrapper is the kernel's
shape function: the card's checks, then an empty output (and gradient) of
the kernel's shape inside the same ``counts.kernel`` region. On a DTensor
table (a step planned on a ``DeviceMesh``) the bag is row-wise sharded,
through ``local_map``: every rank takes all the ids, looks up the rows its
shard of the table holds (the others masked to weight 0, on the kernel or
its plain version), and the (B, d) sums, ``Partial`` over the mesh dims the
table's rows are split on, are reduced onto the ids' batch placement
(``_sharded``).

``launches`` counts the forward kernel's launches and ``bwd_launches`` the
backward's (one a call of its C entry, which runs its three kernels), so a
run can show that its path went through them; ``reset_launches`` and
``reset_bwd_launches`` set them to 0. Under a ``roofline.counts`` counter a
call counts as ``analysis.embedding_bag_work`` and its gradient as
``analysis.embedding_bag_bwd_work`` on either route.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional

import torch

from repro_torch.distributed.sharding import block_index, is_dtensor, split_dims
from repro_torch.kernels import build
from repro_torch.roofline import analysis, counts

#: TPU kernel this replaces (file:line of its wrapper; body ``_kernel`` at
#: :26, ``pallas_call`` at :56)
REPLACES = "src/repro/kernels/embedding_bag.py:45"
SOURCE = "src/repro_torch/kernels/csrc/embedding_bag.cu"
#: the gradient's JAX twin: the VJP of jnp.take in embedding_lookup (the TPU
#: kernel itself has no backward)
BWD_REPLACES = "src/repro/models/recsys.py:44"
BWD_SOURCE = "src/repro_torch/kernels/csrc/embedding_bag_bwd.cu"
#: the backward cuts the positions, sorted by row, into tiles of this many:
#: a row's positions in one tile are summed in order, then its tiles' sums
#: in order (the C library reports its own value, which must be this one)
BWD_CHUNK = 64
#: the kernel reads a row in slices of this many elements (one 8- or
#: 16-byte load a lane), so it takes a width d that is a multiple of it;
#: the plain version takes any width
KERNEL_VEC = 4
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def reset_bwd_launches() -> None:
    global bwd_launches
    bwd_launches = 0


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


def _on_device(t: torch.Tensor):
    """The kernels launch on the runtime's current device: make it ``t``'s."""
    index = t.device.index
    if index is None or index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


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


def _forward(table: torch.Tensor, ids: torch.Tensor,
             weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward on checked inputs: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    global launches
    with counts.kernel(lambda: _work(table, ids, weights)):
        if table.device.type == "cpu":
            return embedding_bag_plain(table, ids, weights)
        if table.device.type == "meta":
            _check_width(table.shape[1])
            return table.new_empty((ids.shape[0], table.shape[1]))
        if table.device.type != "cuda":
            raise ValueError(f"no kernel for device {table.device}")
        if table.shape[1] % KERNEL_VEC:
            raise ValueError(f"the CUDA kernel is compiled for widths that are a "
                             f"multiple of {KERNEL_VEC}, not {table.shape[1]}")
        if table.data_ptr() % 16:
            raise ValueError("table must start on a 16-byte boundary")
        if weights is not None:
            weights = weights.float().contiguous()
        with _on_device(table):
            out = _launch(table, ids, weights)
        launches += 1
        return out


def _check_width(d: int) -> None:
    if d % KERNEL_VEC:
        raise ValueError(f"the CUDA kernel is compiled for widths that are a "
                         f"multiple of {KERNEL_VEC}, not {d}")


def _work(table: torch.Tensor, ids: torch.Tensor, weights: Optional[torch.Tensor]):
    return analysis.embedding_bag_work(ids, weights is not None, table.shape[1], table.dtype,
                                       table.shape[0])


def _bwd_work(grad_out: torch.Tensor, ids: torch.Tensor, weights: Optional[torch.Tensor],
              n_rows: int):
    return analysis.embedding_bag_bwd_work(ids, weights is not None, grad_out.shape[1],
                                           n_rows, grad_out.dtype)


# ------------------------------------------------------------------ gradient --

def _sorted_positions(ids: torch.Tensor, n_rows: int):
    """The backward's order: each position ``p = b * L + l``'s row as
    ``jnp.take`` reads the id (``[-V, 0)`` wraps; an id outside ``[-V, V)``
    gets key ``V``, past every row), and the stable sort of the positions by
    that key: ``(keys int32, perm int64)``, equal rows in order of p."""
    k = ids.reshape(-1).long()
    k = torch.where(k < 0, k + n_rows, k)
    k = k.masked_fill((k < 0) | (k >= n_rows), n_rows).to(torch.int32)
    return torch.sort(k, stable=True)


def embedding_bag_bwd_plain(grad_out: torch.Tensor, ids: torch.Tensor,
                            weights: Optional[torch.Tensor], n_rows: int) -> torch.Tensor:
    """The table gradient in plain PyTorch, in the kernel's order, so the
    two agree bit for bit: the positions sorted by row (``_sorted_positions``)
    are cut into tiles of ``BWD_CHUNK``; a row's positions in one tile (a
    segment) are summed in float32 from 0 in order of p, each product
    ``w * grad_out[b]`` rounded before the add; the row is 0 plus its
    segments' sums in order, rounded once to grad_out's type. Rows no id
    names are 0; ids outside ``[-V, V)`` add nothing."""
    bag_len = ids.shape[1]
    d, dev = grad_out.shape[1], grad_out.device
    grad = torch.zeros((n_rows, d), dtype=grad_out.dtype, device=dev)
    keys, perm = _sorted_positions(ids, n_rows)
    n = int(torch.count_nonzero(keys < n_rows))   # ids outside sort last
    if n == 0:
        return grad
    keys, perm = keys[:n], perm[:n]
    x = grad_out.float()[torch.div(perm, bag_len, rounding_mode="floor")]   # (n, d)
    if weights is not None:
        x = weights.float().reshape(-1)[perm][:, None] * x
    pos = torch.arange(n, device=dev)
    new_seg = pos % BWD_CHUNK == 0
    new_seg[1:] |= keys[1:] != keys[:-1]
    seg_start = pos[new_seg]
    seg_len = torch.diff(seg_start, append=pos.new_tensor([n]))
    seg = torch.zeros((seg_start.numel(), d), dtype=torch.float32, device=dev)
    for k in range(BWD_CHUNK):
        live = (seg_len > k).nonzero().view(-1)
        if live.numel() == 0:
            break
        seg[live] = seg[live] + x[seg_start[live] + k]
    seg_key = keys[seg_start]
    new_row = torch.ones_like(seg_key, dtype=torch.bool)
    new_row[1:] = seg_key[1:] != seg_key[:-1]
    row_start = new_row.nonzero().view(-1)
    row_segs = torch.diff(row_start, append=row_start.new_tensor([seg_key.numel()]))
    acc = torch.zeros((row_start.numel(), d), dtype=torch.float32, device=dev)
    for j in range(int(row_segs.max())):
        live = (row_segs > j).nonzero().view(-1)
        acc[live] = acc[live] + seg[row_start[live] + j]
    grad[seg_key[row_start].long()] = acc.to(grad.dtype)
    return grad


def _check_bwd(grad_out: torch.Tensor, ids: torch.Tensor,
               weights: Optional[torch.Tensor], n_rows: int) -> None:
    if grad_out.dim() != 2 or ids.dim() != 2 or grad_out.shape[0] != ids.shape[0]:
        raise ValueError(f"grad_out must be (B, d) and ids (B, L); got "
                         f"{tuple(grad_out.shape)}, {tuple(ids.shape)}")
    if grad_out.dtype not in _DTYPE_CODES:
        raise TypeError(f"grad_out dtype {grad_out.dtype} not supported "
                        f"(float32 or bfloat16)")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, not {ids.dtype}")
    if not 0 < n_rows < 2 ** 31:
        raise ValueError(f"n_rows must lie in [1, 2^31), not {n_rows}")
    if weights is not None and tuple(weights.shape) != tuple(ids.shape):
        raise ValueError(f"weights must be (B, L) = {tuple(ids.shape)}, "
                         f"not {tuple(weights.shape)}")
    for name, t in (("ids", ids), ("weights", weights)):
        if t is not None and t.device != grad_out.device:
            raise ValueError(f"devices differ: grad_out {grad_out.device}, "
                             f"{name} {t.device}")
    if not grad_out.is_contiguous() or not ids.is_contiguous():
        raise ValueError("grad_out and ids must be contiguous")


def _bwd_kernel_fn():
    lib = build.load_library("embedding_bag_bwd")
    fn = lib.embedding_bag_bwd
    if fn.argtypes is None:
        chunk = lib.embedding_bag_bwd_chunk()
        if chunk != BWD_CHUNK:
            raise RuntimeError(f"embedding_bag_bwd cuts tiles of {chunk} positions; "
                               f"the plain version of {BWD_CHUNK}")
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch_bwd(grad_out: torch.Tensor, ids: torch.Tensor,
                weights: Optional[torch.Tensor], n_rows: int) -> torch.Tensor:
    b, bag_len = ids.shape
    d, dev = grad_out.shape[1], grad_out.device
    keys, perm = _sorted_positions(ids, n_rows)
    n_pos = keys.numel()
    n_tiles = -(-n_pos // BWD_CHUNK)
    grad = torch.empty((n_rows, d), dtype=grad_out.dtype, device=dev)
    partial = torch.empty(max(2 * n_tiles * d, 1), dtype=torch.float32, device=dev)
    named = torch.empty(n_rows, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_kernel_fn()(_DTYPE_CODES[grad_out.dtype], grad_out.data_ptr(), d,
                           keys.data_ptr(), perm.data_ptr(),
                           None if weights is None else weights.data_ptr(), n_pos,
                           bag_len, n_rows, grad.data_ptr(), partial.data_ptr(),
                           partial.numel(), named.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"embedding_bag_bwd kernel launch failed: CUDA error {err} "
                           f"at V={n_rows} d={d} B={b} L={bag_len} {grad_out.dtype}")
    return grad


def embedding_bag_bwd(grad_out: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor], n_rows: int) -> torch.Tensor:
    """grad_out (B, d), ids (B, L) int32, weights (B, L) or None -> the dense
    (n_rows, d) table gradient in grad_out's type: the CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    global bwd_launches
    _check_bwd(grad_out, ids, weights, n_rows)
    with counts.kernel(lambda: _bwd_work(grad_out, ids, weights, n_rows)):
        if grad_out.device.type == "cpu":
            return embedding_bag_bwd_plain(grad_out, ids, weights, n_rows)
        if grad_out.device.type == "meta":
            _check_width(grad_out.shape[1])
            return grad_out.new_empty((n_rows, grad_out.shape[1]))
        if grad_out.device.type != "cuda":
            raise ValueError(f"no kernel for device {grad_out.device}")
        if grad_out.shape[1] % KERNEL_VEC:
            raise ValueError(f"the CUDA kernel is compiled for widths that are a "
                             f"multiple of {KERNEL_VEC}, not {grad_out.shape[1]}")
        if grad_out.data_ptr() % 16:
            raise ValueError("grad_out must start on a 16-byte boundary")
        if weights is not None:
            weights = weights.float().contiguous()
        with _on_device(grad_out):
            grad = _launch_bwd(grad_out, ids, weights, n_rows)
        bwd_launches += 1
        return grad


class EmbeddingBag(torch.autograd.Function):
    """The bag with its table gradient: on CUDA tensors the forward kernel,
    then the backward kernel; on CPU tensors, or with ``plain`` True (the
    route a check holds the kernels against, on any device), both plain
    versions. Saves ids and weights, not the table. The weights get no
    gradient. The backward is differentiable once."""

    @staticmethod
    def forward(ctx, table, ids, weights, plain=False):
        ctx.n_rows, ctx.plain = table.shape[0], plain
        ctx.save_for_backward(ids, weights)
        if plain:
            with counts.kernel(lambda: _work(table, ids, weights)):
                return embedding_bag_plain(table, ids, weights)
        return _forward(table, ids, weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        ids, weights = ctx.saved_tensors
        grad_out = grad_out.contiguous()   # autograd may hand over a strided gradient
        if ctx.plain:
            _check_bwd(grad_out, ids, weights, ctx.n_rows)
            with counts.kernel(lambda: _bwd_work(grad_out, ids, weights, ctx.n_rows)):
                grad = embedding_bag_bwd_plain(grad_out, ids, weights, ctx.n_rows)
        else:
            grad = embedding_bag_bwd(grad_out, ids, weights, ctx.n_rows)
        return grad, None, None, None


def _refuse_weight_grad(weights: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and weights is not None and weights.requires_grad:
        raise NotImplementedError("embedding_bag: the gradient of the bag weights is "
                                  "not ported yet (ROADMAP.md §2); no path trains them")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """table (V, d), ids (B, L) int32, weights (B, L) or None -> (B, d) in
    the table's type: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Where grad is enabled and the table requires it, through
    ``EmbeddingBag``, whose backward is the CUDA backward kernel (the plain
    backward on CPU tensors). Meta tensors get an empty output after the
    card's checks; a DTensor table is looked up row-wise (``_sharded``)."""
    if is_dtensor(table):
        return _sharded(embedding_bag, table, ids, weights)
    _check(table, ids, weights)
    _refuse_weight_grad(weights)
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBag.apply(table, ids, weights)
    return _forward(table, ids, weights)


def _sharded(bag, table, ids, weights):
    """``bag`` (a wrapper) over a DTensor table, row-wise: the table stays
    where it is (rows split over the mesh dims it is ``Shard(0)`` on,
    whole on the others), the ids and weights are gathered whole onto
    every rank, each rank sums the rows its block holds (the others at
    weight 0, so a bag of rows all elsewhere is 0), and the sums,
    ``Partial`` over the split dims, are reduced onto the ids' batch
    placement (a reduce-scatter where the ids were split by rows). An id
    outside ``[-V, V)`` makes its bag NaN on every rank, so in the sum, as
    in the unsharded call."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    split = split_dims(table, 0)
    t_place = tuple(Shard(0) if i in split else Replicate() for i in range(mesh.ndim))
    whole = tuple(Replicate() for _ in t_place)
    out_place = tuple(Partial() if isinstance(pl, Shard) else Replicate() for pl in t_place)
    v = table.shape[0]
    n_split = 1
    for i in split:
        n_split *= mesh.size(i)
    rows = v // n_split

    def local(tl, il, wl):
        if n_split == 1:
            return bag(tl, il, wl)
        block = block_index(mesh, split)
        gid = il.long()
        gid = torch.where(gid < 0, gid + v, gid)
        outside = ((gid < 0) | (gid >= v)).any(dim=1, keepdim=True)
        rel = gid - block * rows
        mine = (rel >= 0) & (rel < rows)
        w = mine.float() if wl is None else torch.where(mine, wl.float(), 0.0)
        out = bag(tl, torch.where(mine, rel, 0).to(torch.int32), w)
        return out.masked_fill(outside, float("nan"))

    batch = ids.placements if isinstance(ids, DTensor) else whole
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, whole, run_check=False)
    if weights is not None and not isinstance(weights, DTensor):
        weights = DTensor.from_local(weights, mesh, whole, run_check=False)
    w_place = None if weights is None else whole
    out = local_map(local, out_placements=list(out_place),
                    in_placements=(t_place, whole, w_place),
                    device_mesh=mesh, redistribute_inputs=True)(table, ids, weights)
    return out.redistribute(mesh, tuple(pl if isinstance(pl, Shard) and pl.dim == 0
                                        else Replicate() for pl in batch))


def embedding_bag_plain_route(table: torch.Tensor, ids: torch.Tensor,
                              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``embedding_bag`` through both plain versions on any device: the
    route a check on the card holds the kernels against, forward and
    gradient, bit for bit. No user path calls it."""
    if is_dtensor(table):
        return _sharded(embedding_bag_plain_route, table, ids, weights)
    _check(table, ids, weights)
    _refuse_weight_grad(weights)
    if torch.is_grad_enabled() and table.requires_grad:
        return EmbeddingBag.apply(table, ids, weights, True)
    with counts.kernel(lambda: _work(table, ids, weights)):
        return embedding_bag_plain(table, ids, weights)
