"""Counts the work a torch program does, in place of the JAX package's
``hlo_parse.py``: the same ``Counts`` (flops, bytes_accessed,
collective_bytes, link_bytes, n_collectives), read from the aten ops the
program dispatches as it runs, not from compiled HLO.

  counts = count(fn, *args, **kwargs)

* FLOPs come from ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, fused attention): 2 M N K for an (M, K) x (K, N) product.
* Bytes are each aten op's operands plus its result, each tensor's
  elements times their size, skipping views and metadata ops
  (``_NO_BYTES_OPS``), which move no data.
* Eager execution runs every loop iteration through the counter, so a loop
  is counted as many times as it runs: there is no trip-count correction,
  where ``hlo_parse`` multiplies a ``while`` body by its trip count.
* Collectives are the c10d ones the program dispatches (``c10d`` ops,
  which ``torch.distributed`` calls, the functional ``_c10d_functional``
  ones DTensor uses, and DTensor's own ``shard_dim_alltoall``):
  all-to-all, all-reduce, all-gather and reduce-scatter. Each adds its result's bytes to
  ``collective_bytes`` and one to ``n_collectives`` under its kind, and to
  ``link_bytes`` its ring-model bytes over the links at the group's size g,
  ``hlo_parse``'s model: 2 (g-1)/g of the result for an all-reduce, (g-1)/g
  for an all-gather or an all-to-all, (g-1) times the result for a
  reduce-scatter; a group of one adds 0.

Under DTensor the counts are one rank's, as ``hlo_parse.analyze``'s are
one device's: an op on DTensors is not counted at its global shapes;
the counter hands it on to DTensor (returning ``NotImplemented``), and
counts the ops DTensor then runs on this rank's local shards and the
collectives its redistributions issue. The global-shape ops DTensor's
sharding propagation runs under a ``FakeTensorMode`` to learn an output's
shape are not counted either. Plain tensors are counted as before.

A hand-written kernel counts as its work formula on either route. Its
wrapper opens ``kernel(work)`` around the call: the active counter adds
``work()``'s (operations, bytes) from ``roofline.analysis`` and counts none
of the aten ops inside, so the kernel on the card and its plain version on
the CPU read the same work. A region inside another records nothing.

The counter is a ``TorchDispatchMode``, and the wrappers find it on the
dispatch-mode stack: autograd carries that stack to the thread that runs a
backward on the card, where a Python global set by the caller's thread or
a ``contextvar`` would not be seen.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that move no data themselves: aliasing, allocation without a write,
# and metadata. Views (``OpOverload.is_view``) are skipped as well.
_NO_BYTES_OPS = frozenset({
    _aten.detach, _aten.alias, _aten.lift_fresh, _aten._unsafe_view,
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.resize_, _aten.set_,
    _aten.sym_size, _aten.sym_stride, _aten.sym_numel, _aten.sym_storage_offset,
    _aten.is_same_size, _aten.is_nonzero, _aten._local_scalar_dense,
})


@dataclasses.dataclass
class Counts:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    link_bytes: float = 0.0     # ring-model per-device bytes over links
    n_collectives: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})

    def add(self, other: "Counts", mult: float = 1.0):
        self.flops += mult * other.flops
        self.bytes_accessed += mult * other.bytes_accessed
        self.link_bytes += mult * other.link_bytes
        for c in COLLECTIVES:
            self.collective_bytes[c] += mult * other.collective_bytes[c]
            self.n_collectives[c] += int(mult * other.n_collectives[c])


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def op_bytes(func, args, kwargs, out) -> int:
    """Operands plus result of one aten op; 0 for a view or metadata op."""
    if func.is_view or func.overloadpacket in _NO_BYTES_OPS:
        return 0
    return _tensor_bytes((args, kwargs)) + _tensor_bytes(out)


#: c10d op -> its kind; a ``c10d`` op's first argument holds its result
#: (the output tensors, or the tensors reduced in place), a functional op
#: returns it
_COLLECTIVE_OPS = {
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "shard_dim_alltoall": "all-to-all",     # DTensor's Shard(i) -> Shard(j)
}


def _group_size(args) -> int:
    """The size of the process group a c10d op names: a boxed
    ``ProcessGroup`` argument (``c10d``) or a group name (functional)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in reversed(args):    # a functional op's group name comes last, after a reduce op's
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:        # another boxed class (a ReduceOp)
                continue
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    raise ValueError("a collective with no process group among its arguments")


def collective(func, args, out) -> Optional[Tuple[str, int, int]]:
    """(kind, result bytes, group size) of a c10d collective, else None."""
    if func.namespace not in ("c10d", "_c10d_functional", "_dtensor"):
        return None
    kind = _COLLECTIVE_OPS.get(func.overloadpacket.__name__)
    if kind is None:
        return None
    result = args[0] if func.namespace == "c10d" else out
    return kind, _tensor_bytes(result), _group_size(args)


def link_bytes(kind: str, size: float, g: int) -> float:
    """Ring-model bytes over the links of one collective of ``size`` result
    bytes over ``g`` ranks (``hlo_parse.HLOAnalysis._op_counts``)."""
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g * size
    if kind == "reduce-scatter":
        return (g - 1) * size  # input = g x result
    return (g - 1) / g * size  # all-gather, all-to-all


def op_flops(func, args, kwargs, out) -> int:
    formula = flop_registry.get(func.overloadpacket)
    return 0 if formula is None else formula(*args, **kwargs, out_val=out)


def _dtensor_types(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _faking() -> bool:
    return torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None


class Counter(TorchDispatchMode):
    """Adds up the FLOPs and bytes of every aten op dispatched while it is
    entered, outside hand-kernel regions (``kernel``); ``counts`` holds the
    totals."""

    def __init__(self):
        super().__init__()
        self.counts = Counts()
        self._kernel_depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _dtensor_types(types):
            # DTensor runs the op on the local shards, which come back here
            return NotImplemented
        if _faking():
            # sharding propagation's global-shape shadow of a DTensor op
            return func(*args, **kwargs)
        if func.overloadpacket not in flop_registry:
            # a composite op (matmul under inference mode reaches the mode
            # whole) is counted as the ops it decomposes into
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if self._kernel_depth == 0:
            self.counts.flops += op_flops(func, args, kwargs, out)
            self.counts.bytes_accessed += op_bytes(func, args, kwargs, out)
            coll = collective(func, args, out)
            if coll is not None:
                kind, size, g = coll
                self.counts.collective_bytes[kind] += size
                self.counts.n_collectives[kind] += 1
                self.counts.link_bytes += link_bytes(kind, size, g)
        return out


def count(fn: Callable, *args, **kwargs) -> Counts:
    """The work of one call ``fn(*args, **kwargs)``."""
    with Counter() as counter:
        fn(*args, **kwargs)
    return counter.counts


def active() -> Optional[Counter]:
    """The innermost ``Counter`` on the dispatch-mode stack, or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Counter):
            return mode
    return None


class _Region:
    __slots__ = ("counter",)

    def __init__(self, counter: Counter):
        self.counter = counter

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.counter._kernel_depth -= 1
        return False


_NOTHING = contextlib.nullcontext()


def kernel(work: Callable[[], Tuple[float, float]]):
    """A hand-kernel call's region: the active counter adds ``work()``'s
    (operations, bytes) and none of the aten ops run inside, on either
    route. ``work`` is called only under a counter (its formula may read
    the call's ids), and not inside another region."""
    counter = active()
    if counter is None:
        return _NOTHING
    counter._kernel_depth += 1
    if counter._kernel_depth == 1:
        try:
            ops, n_bytes = work()
        except BaseException:
            counter._kernel_depth -= 1
            raise
        counter.counts.flops += ops
        counter.counts.bytes_accessed += n_bytes
    return _Region(counter)
