"""Causal GQA attention, forward and gradient: the attention of every LM
prefill layer and of every training step.

  q (B, S, H, d), k/v (B, S, Hkv, d) -> (B, S, H, d), causal, scale 1/sqrt(d)

``flash_attention`` is the wrapper the model calls. A CUDA tensor goes to the
hand-written Hopper kernel in ``csrc/flash_attention.cu`` (the port of the
TPU kernel ``src/repro/kernels/flash_attention.py:63``), built on first use
and bound with ``ctypes``; a CPU tensor goes to ``flash_attention_plain``,
the plain PyTorch version of the same function. There is no other route: a
CUDA call launches the kernel or raises.

The C entry point picks a kernel by dtype:

* bfloat16, the serving path: both products on the tensor cores
  (``wgmma``: bf16 in, float32 sums, the reference's own arithmetic), P
  kept in registers between them, K/V tiles arriving by TMA into a 2-stage
  ring that a producer warpgroup keeps full for two consumer warpgroups.
  That is stage 2 of the tensor-core design (stage 1 was ``mma.sync`` +
  ``cp.async``). One kernel template, compiled at head widths 64
  (granite-3-2b's) and 128 (qwen3-0.6b's and the MoE configs'). The work
  is bound by operations: 1.375e11 at B=8, S=2048 (H=16, Hkv=8, d=128, and
  as much at granite's H=32, Hkv=8, d=64), 0.139 ms at the card's 989
  TFLOP/s.
* float32: the tensor cores too, in 3xTF32. One TF32 product (about three
  decimal digits) cannot meet float32's 2e-5, three can: each operand split
  into a TF32 high and low part, hi*hi + hi*lo + lo*hi summed in float32
  (``csrc/tf32.cuh``). ``wgmma`` + TMA with a warpgroup that loads and
  splits the tiles for two consumer warpgroups; bound by the same 1.375e11
  operations, 0.833 ms in 3xTF32 at the card's 495 TFLOP/s of TF32. Head
  width 128 only.

``KERNEL_HEAD_DIMS`` says which head widths each direction and dtype is
compiled for: bfloat16 64 and 128 both ways, float32 128 both ways. A call
at another width raises ``ValueError`` before any launch, and so does a
call that would need the gradient at a width the backward does not take
(float32 at d=64), before the forward runs.

Query head ``h`` attends with KV head ``h // G`` (``G = H / Hkv``). The
forward and the backward take any ``G`` up to ``KERNEL_ROWS`` (128), as
the Pallas kernel and ``_flash_bwd_rule`` do: deepseek-coder-33b's 56
heads over 8 give G=7, which the kernels pad to 8 rows a position. The
forward never stores the eighth; the backward reads Q and dO through a view
whose eighth row is zeros, so it adds nothing to dk and dv, and never stores
its dq. A ``G`` past 128 raises ``ValueError`` before anything launches. Any ``S >= 1``
works: the kernel masks the ragged tail itself, where the Pallas kernel
asserted ``S % block == 0``. It reads and writes the
``(B, S, H, d)`` layouts in place, so the wrapper makes no transposed copy.

The gradient. Where grad is enabled and an input requires it,
``flash_attention`` goes through ``FlashAttention`` (a
``torch.autograd.Function``), the port of the custom VJP of the JAX
package's ``flash_attention_jnp`` (``src/repro/models/layers.py:216``): its
forward also writes each row's log-sum-exp ``lse`` (B, H, S) float32 (the
kernel's optional output; ``flash_attention_fwd_plain`` on the CPU), and its
backward recomputes each tile's probabilities from it, on CUDA tensors in
the hand-written kernels of ``csrc/flash_attention_bwd.cu`` (a library of
its own, so the serving forward's build is untouched: FlashAttention-2's
dk/dv and dq kernels without atomics, so the gradients are the same from
run to run; bfloat16 warp-specialised on the tensor cores, every product a
``wgmma`` and every tile arriving by TMA into a 2-stage ring, as in the
forward, and like it one template compiled at head widths 64 and 128;
float32 in 3xTF32 ``mma.sync`` fed by TMA, since the ``wgmma``
form's tiles do not fit a block), on CPU tensors in
``flash_attention_bwd_plain``. Serving runs under ``torch.inference_mode()``
and keeps the forward with no ``lse`` written.

Two more kinds of input. On ``meta`` tensors (the dry-run planner's) the
wrapper is the kernel's shape function: the same checks as on the card,
then empty outputs of the kernel's shapes (``lse`` too), inside the same
``counts.kernel`` region, so a planned step counts the kernel's work and
launches nothing. On DTensors (a step planned on a ``DeviceMesh``) it runs
on each rank's local shards through ``local_map``, the twin of JAX's
``shard_map``: the batch over the data axes, the heads over ``model``
where they divide, the sequence whole (a sequence-parallel input is
gathered first). Where the query heads split over ``model`` and the KV
heads cannot (qwen3-0.6b's 8 over 16 ranks), the KV heads arrive whole and
each rank slices the ones its query heads read (``_kv_heads_of``), so the
local call keeps ``h // G``; their gradient is ``Partial`` over ``model``.

``launches`` counts the forward kernel's launches and ``bwd_launches`` the
backward's (one a call of its C entry, which runs its three kernels), so a
run can show that its path went through them; ``reset_launches`` and
``reset_bwd_launches`` set them to 0. ``route_info`` and ``bwd_route_info``
report what a dtype's kernels hold on the card (registers, spills, shared
memory, resident blocks).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Tuple

import torch

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels import build
from repro_torch.roofline import analysis, counts

#: TPU kernel this replaces (file:line of its wrapper; body ``_kernel`` at
#: :24, ``pallas_call`` at :77)
REPLACES = "src/repro/kernels/flash_attention.py:63"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: the gradient's JAX twin: the backward rule of flash_attention_jnp's
#: custom VJP (the TPU kernel itself has no backward)
BWD_REPLACES = "src/repro/models/layers.py:235"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
#: head widths the CUDA kernels are compiled for, by (direction, dtype): the
#: bfloat16 forward and backward at 64 (granite-3-2b's) and 128 (qwen3-0.6b's),
#: the float32 forward and backward at 128; the plain versions take any width
KERNEL_HEAD_DIMS = {
    ("forward", torch.bfloat16): (64, 128),
    ("forward", torch.float32): (128,),
    ("backward", torch.bfloat16): (64, 128),
    ("backward", torch.float32): (128,),
}
#: a block's query rows, positions x the query heads of one KV head: the
#: forward and the backward take any group size G = H / Hkv up to it (a G
#: that is not a power of two is padded to the next, leaving rows of a
#: block idle)
KERNEL_ROWS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the design of a kernel, by the code both C libraries report (the
#: forward's route stage, the backward's kernels' design)
DESIGNS = {2: "wgmma + TMA", 3: "3xTF32 mma.sync + TMA", 4: "3xTF32 wgmma + TMA"}
#: the mask value: exp(-1e30 - m) is 0 without NaN, unlike -inf
MASK = -1e30

#: the plain forward's and backward's kv chunk (the JAX package's default)
KV_CHUNK = 512

launches = 0
bwd_launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def reset_bwd_launches() -> None:
    global bwd_launches
    bwd_launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_start: int = 0) -> torch.Tensor:
    """Materialised-softmax causal GQA attention, the port of the JAX
    package's oracle ``ref.flash_attention_ref``: (B, Hkv, G, Sq, S) float32
    scores, ``-1e30`` above the diagonal, a float32 softmax, the
    probabilities in v's type, summed in float32, the result in q's type.

    ``q`` may hold the ``Sq`` query rows of positions ``q_start ..
    q_start + Sq - 1`` of a sequence whose ``S`` keys ``k``/``v`` hold, so a
    slice of rows of a long sequence is checked without its full scores."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg = q.reshape(b, sq, hkv, g, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    scores = scores / math.sqrt(d)
    q_pos = torch.arange(q_start, q_start + sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    scores = torch.where(k_pos[None, :] <= q_pos[:, None], scores, MASK)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              kv_chunk: int = KV_CHUNK
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward with its log-sum-exp, the port of the JAX package's
    ``_flash_fwd_impl`` (``src/repro/models/layers.py:178``): an online
    softmax over chunks of ``kv_chunk`` keys, float32 scores, the
    probabilities in v's type for the P V product, float32 sums. Returns
    ``(out, lse)``: ``out`` in q's type, ``lse`` (B, H, S) float32, each
    row's natural log-sum-exp of its scaled scores (JAX's (B, Hkv, G, S)
    flattened). The last chunk may be short: JAX pads it with keys past
    every query, which the causal mask drops."""
    b, sq, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    kv_chunk = min(kv_chunk, max(s, 1))
    qg = q.reshape(b, sq, hkv, g, d).float()
    q_pos = torch.arange(sq, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, hkv, g, sq), MASK, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    for i0 in range(0, s, kv_chunk):
        kt, vt = k[:, i0:i0 + kv_chunk], v[:, i0:i0 + kv_chunk]
        kv_pos = torch.arange(i0, i0 + kt.shape[1], device=q.device)
        sc = torch.einsum("bqkgd,bckd->bkgqc", qg, kt.float()) * scale
        sc = torch.where(kv_pos[None, :] <= q_pos[:, None], sc, MASK)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bkgqc,bckd->bkgqd", p.to(v.dtype).float(), vt.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    l = torch.clamp(l, min=1e-30)
    lse = m + torch.log(l)
    out = (acc / l[..., None]).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype), lse.reshape(b, h, sq)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                              kv_chunk: int = KV_CHUNK
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient, the port of the JAX package's ``_flash_bwd_rule``
    (``src/repro/models/layers.py:235``) with its mixed precision, chunk of
    ``kv_chunk`` keys by chunk, never building the (S, S) scores: for each
    chunk, p = exp(s * scale - lse) recomputed in float32; dv = p^T dout with
    p in float32; dp = dout v^T; ds = p (dp - delta) scale with delta =
    rowsum(dout * out); dq += ds k and dk = ds^T q with ds cast to the
    input's type; sums in float32. Returns ``(dq, dk, dv)`` in the inputs'
    types."""
    b, sq, h, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    kv_chunk = min(kv_chunk, max(s, 1))
    qg = q.reshape(b, sq, hkv, g, d).float()
    dog = dout.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()   # (B,K,G,Sq,D)
    og = out.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()
    delta = (dog * og).sum(-1)
    lse = lse.reshape(b, hkv, g, sq)
    q_pos = torch.arange(sq, device=q.device)
    dq = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i0 in range(0, s, kv_chunk):
        kt, vt = k[:, i0:i0 + kv_chunk].float(), v[:, i0:i0 + kv_chunk].float()
        kv_pos = torch.arange(i0, i0 + kt.shape[1], device=q.device)
        sc = torch.einsum("bqkgd,bckd->bkgqc", qg, kt) * scale
        sc = torch.where(kv_pos[None, :] <= q_pos[:, None], sc, MASK)
        p = torch.exp(sc - lse[..., None])                       # (B,K,G,Sq,C)
        dvs.append(torch.einsum("bkgqc,bkgqd->bckd", p, dog).to(v.dtype))
        dp = torch.einsum("bkgqd,bckd->bkgqc", dog, vt)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bkgqc,bckd->bkgqd", ds.to(k.dtype).float(), kt)
        dks.append(torch.einsum("bkgqc,bqkgd->bckd", ds.to(q.dtype).float(), qg
                                ).to(k.dtype))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
    return dq, torch.cat(dks, 1), torch.cat(dvs, 1)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, d), (B, S, Hkv, d); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype} not supported (float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes differ: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k and v must be (B, S, Hkv, d) = ({b}, {s}, Hkv, {d}); "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{h} query heads do not divide into {hkv} KV heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"devices differ: q {q.device}, k {k.device}, v {v.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b == 0 or s == 0 or h == 0 or d == 0:
        raise ValueError(f"empty input: q shape {tuple(q.shape)}")


def _kernel_fn():
    fn = build.load_library("flash_attention").flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _bwd_kernel_fn():
    fn = build.load_library("flash_attention_bwd").flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_longlong]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_scratch_values(b: int, s: int, h: int, hkv: int) -> int:
    """float32 values of scratch the backward kernels take: each row's
    (lse, delta) (bfloat16: lse log2 e), a (batch row, KV head)'s S x Gp
    rows padded to 128, Gp the power of two at or above G = H / Hkv (the
    kernels' rows; ``STAT_ROWS`` and ``scratch_values`` of
    ``csrc/flash_attention_bwd.cu``, which refuses a smaller scratch)."""
    gp = 1 << (h // hkv - 1).bit_length()
    return 2 * b * hkv * (-(-s * gp // 128) * 128)


def route_info(dtype: torch.dtype, d: int = 128) -> dict:
    """The CUDA kernel that serves ``dtype`` at head width ``d`` on the
    current card: its design stage, registers and local (spill) bytes a
    thread, static and dynamic shared memory a block, blocks resident on an
    SM and threads a block, from the CUDA runtime (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    _check_head_width(dtype, d, grad=False)
    fn = build.load_library("flash_attention").flash_attention_route_info
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * 7)()
    err = fn(_DTYPE_CODES[dtype], d, info)
    if err != 0:
        raise RuntimeError(f"flash_attention_route_info failed: CUDA error {err}")
    keys = ("stage", "registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads")
    out = dict(zip(keys, info))
    out["design"] = DESIGNS[out["stage"]]
    return out


def bwd_route_info(dtype: torch.dtype, d: int = 128) -> dict:
    """The backward's two kernels for ``dtype`` at head width ``d`` on the
    current card, as ``{"dkdv": {...}, "dq": {...}}``: registers and local
    (spill) bytes a thread, static and dynamic shared memory a block, blocks
    resident on an SM, threads a block and the design (bfloat16: ``wgmma`` +
    TMA, 384 threads; float32: 3xTF32 ``mma.sync`` + TMA, 256 threads; both
    on the tensor cores). A width the backward of ``dtype`` is not compiled
    for raises ``ValueError``."""
    widths = KERNEL_HEAD_DIMS[("backward", dtype)]
    if d not in widths:
        raise ValueError(f"the CUDA kernel is compiled for head widths {widths} in the "
                         f"backward of {dtype}, not {d}")
    fn = build.load_library("flash_attention_bwd").flash_attention_bwd_route_info
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads", "design")
    out = {}
    for which, name in enumerate(("dkdv", "dq")):
        info = (ctypes.c_int * 7)()
        err = fn(_DTYPE_CODES[dtype], which, d, info)
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd_route_info failed: CUDA error {err}")
        out[name] = dict(zip(keys, info))
        out[name]["design"] = DESIGNS[out[name]["design"]]
    return out


def _check_head_width(dtype: torch.dtype, d: int, grad: bool) -> None:
    """Raises ``ValueError`` unless the forward kernel of ``dtype`` is
    compiled for head width ``d``, and with ``grad`` the backward kernel
    too (a call that needs the gradient runs both)."""
    directions = ("forward", "backward") if grad else ("forward",)
    for direction in directions:
        widths = KERNEL_HEAD_DIMS[(direction, dtype)]
        if d not in widths:
            raise ValueError(f"the CUDA kernel is compiled for head widths {widths} "
                             f"in the {direction} of {dtype}, not {d}")


def _check_group(g: int) -> None:
    """Raises ``ValueError`` unless the kernels take ``g`` query heads a
    KV head: any up to ``KERNEL_ROWS``, the forward and the backward
    alike."""
    if g > KERNEL_ROWS:
        raise ValueError(f"the CUDA kernels take up to {KERNEL_ROWS} query heads per KV "
                         f"head, not {g}")


def _check_shapes_for_kernel(q: torch.Tensor, k: torch.Tensor, grad: bool) -> None:
    """The checks of ``_check_kernel`` that read shapes and types only."""
    b, s, h, d = q.shape
    _check_head_width(q.dtype, d, grad)
    _check_group(h // k.shape[2])
    if b > 65535 or k.shape[2] > 65535:
        raise ValueError(f"the CUDA kernel's grid takes B and Hkv up to 65535, "
                         f"not B={b} Hkv={k.shape[2]}")


def _check_kernel(*tensors: torch.Tensor, grad: bool = False) -> None:
    """What the CUDA kernels take beyond ``_check``: q, k, v (and, for the
    backward, out and dout) on the card, a head width ``KERNEL_HEAD_DIMS``
    lists for the dtype (for the backward too where ``grad``), a G up to
    ``KERNEL_ROWS``, B and Hkv within the grid, each tensor on a 16-byte
    boundary."""
    q, k = tensors[0], tensors[1]
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check_shapes_for_kernel(q, k, grad)
    for name, t in zip(("q", "k", "v", "out", "dout", "lse"), tensors):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _on_device(t: torch.Tensor):
    """The kernels launch on the runtime's current device: make it ``t``'s."""
    index = t.device.index
    if index is None or index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(index)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            with_lse: bool = False, out=None):
    """The forward kernel: ``out``, and with ``with_lse`` also ``lse``
    (B, H, S) float32. ``out``, where given, is a contiguous tensor like
    ``q`` that the kernel writes into (a check can fence it)."""
    global launches
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if out is None:
        out = torch.empty_like(q)
    elif (out.shape != q.shape or out.dtype != q.dtype or out.device != q.device
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be contiguous {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}, on a 16-byte boundary")
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel_fn()(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), out.data_ptr(),
                           None if lse is None else lse.data_ptr(), b, s, h, hkv, d,
                           1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} at B={b} S={s} H={h} Hkv={hkv} d={d} {q.dtype}")
    launches += 1
    return (out, lse) if with_lse else out


def _launch_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                lse: torch.Tensor, dout: torch.Tensor, grads=None):
    """The backward kernels: ``(dq, dk, dv)``. ``grads``, where given, is
    ``(dq, dk, dv)``: contiguous tensors like ``q``, ``k``, ``v`` that the
    kernels write into (a check can fence them)."""
    global bwd_launches
    b, s, h, d = q.shape
    hkv = k.shape[2]
    if (out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype
            or dout.dtype != q.dtype or lse.shape != (b, h, s)
            or lse.dtype != torch.float32 or not lse.is_contiguous()
            or not out.is_contiguous() or not dout.is_contiguous()
            or not (q.device == out.device == dout.device == lse.device)):
        raise ValueError(f"the backward takes out and dout like q {tuple(q.shape)} "
                         f"{q.dtype} and lse (B, H, S) float32, all contiguous on "
                         f"{q.device}")
    _check_kernel(q, k, v, out, dout, lse, grad=True)
    if grads is None:
        grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    elif any(g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
             or not g.is_contiguous() or g.data_ptr() % 16 for g, x in zip(grads, (q, k, v))):
        raise ValueError("grads must be contiguous tensors like q, k, v, on a 16-byte "
                         "boundary")
    dq, dk, dv = grads
    # float32 scratch for each row's lse and delta, in the kernels' row order
    scratch = torch.empty(_bwd_scratch_values(b, s, h, hkv), dtype=torch.float32,
                          device=q.device)
    with _on_device(q):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernel_fn()(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                               lse.data_ptr(), scratch.data_ptr(), scratch.numel(),
                               dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h,
                               hkv, d, 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error "
                           f"{err} at B={b} S={s} H={h} Hkv={hkv} d={d} {q.dtype}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: on CUDA tensors the forward kernel with
    its ``lse`` output, then the backward kernels; on CPU tensors
    ``flash_attention_fwd_plain`` and ``flash_attention_bwd_plain``. Saves
    q, k, v, out and lse (B, H, S) for the backward, never the scores. The
    backward is differentiable once: a second-order gradient raises."""

    @staticmethod
    def forward(ctx, q, k, v):
        with counts.kernel(lambda: analysis.attention_work(*_dims(q, k), q.dtype, lse=True)):
            if q.device.type == "cpu":
                out, lse = flash_attention_fwd_plain(q, k, v)
            elif q.device.type == "meta":
                out, lse = torch.empty_like(q), q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                                                            dtype=torch.float32)
            else:
                out, lse = _launch(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with counts.kernel(lambda: analysis.attention_bwd_work(*_dims(q, k), q.dtype)):
            dout = dout.contiguous()   # autograd may hand over a strided gradient
            if q.device.type == "cpu":
                return flash_attention_bwd_plain(q, k, v, out, lse, dout)
            if q.device.type == "meta":
                return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            return _launch_bwd(q, k, v, out, lse, dout)


def _dims(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """(B, S, H, Hkv, d) of a call."""
    b, s, h, d = q.shape
    return b, s, h, k.shape[2], d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d), (B, S, Hkv, d) x2 -> (B, S, H, d) in q's type, causal:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors. Where
    grad is enabled and an input requires it, through ``FlashAttention``,
    whose backward is the CUDA backward kernel (the plain backward on CPU
    tensors). A CUDA call at a head width ``KERNEL_HEAD_DIMS`` does not list
    for its dtype, or for the backward where grad is needed, or at a G past
    ``KERNEL_ROWS``, raises ``ValueError`` before anything launches. Under a ``roofline.counts``
    counter either route counts as ``analysis.attention_work`` (with the lse
    where it goes through ``FlashAttention``), its backward as
    ``analysis.attention_bwd_work``. Meta tensors get empty outputs after
    the card's checks; DTensors run on their local shards (``_sharded``)."""
    if is_dtensor(q):
        return _sharded(q, k, v)
    _check(q, k, v)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if q.device.type == "meta":
        _check_shapes_for_kernel(q, k, grad)
    elif q.device.type != "cpu":
        _check_kernel(q, k, v, grad=grad)   # before any launch, the forward's too
    if grad:
        return FlashAttention.apply(q, k, v)
    with counts.kernel(lambda: analysis.attention_work(*_dims(q, k), q.dtype)):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v)
        if q.device.type == "meta":
            return torch.empty_like(q)
        return _launch(q, k, v)


def _kv_heads_of(h_local: int, first: int, g: int, k: torch.Tensor, v: torch.Tensor):
    """The KV heads that query heads ``first .. first + h_local - 1`` read
    (head h reads KV head h // g), cut from the whole k and v: a run of
    ``h_local // g`` heads where ``g`` divides ``h_local``, the one head
    where ``h_local`` divides ``g``, else one head a query head (G = 1)."""
    if h_local % g == 0:
        lo, n = first // g, h_local // g
    elif g % h_local == 0:
        lo, n = first // g, 1
    else:
        idx = torch.div(torch.arange(first, first + h_local, device=k.device), g,
                        rounding_mode="floor")
        return k.index_select(2, idx), v.index_select(2, idx)
    return k[:, :, lo:lo + n], v[:, :, lo:lo + n]


def _sharded(q, k, v):
    """``flash_attention`` of DTensors on their mesh, through ``local_map``:
    q placed (data axes, -, model, -), k and v (data axes, -, model or
    whole, -), the data axes only where they divide B and ``model`` only
    where it divides the heads; each rank runs the wrapper (the kernel, the
    plain version or the shape function) on its shards. The output is
    placed as q."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.mesh import axis_size, data_axes, mesh_shape
    from repro_torch.distributed.sharding import P, placements

    mesh = q.device_mesh
    sizes = mesh_shape(mesh)
    b, _, h, _ = q.shape
    hkv = k.shape[2]
    dp = data_axes(mesh)
    batch = dp if dp and b % axis_size(mesh, *dp) == 0 else None
    m = sizes.get("model", 1)
    q_heads = "model" if "model" in sizes and h % m == 0 else None
    kv_heads = "model" if q_heads is not None and hkv % m == 0 else None
    q_place = placements(P(batch, None, q_heads, None), mesh)
    kv_place = placements(P(batch, None, kv_heads, None), mesh)
    sliced = q_heads is not None and kv_heads is None and m > 1
    kv_grad = tuple(Partial() if sliced and name == "model" else pl
                    for name, pl in zip(sizes, kv_place))

    def local(ql, kl, vl):
        if sliced:
            first = mesh.get_local_rank("model") * ql.shape[2]
            kl, vl = _kv_heads_of(ql.shape[2], first, h // hkv, kl, vl)
        return flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous())

    return local_map(local, out_placements=list(q_place),
                     in_placements=(q_place, kv_place, kv_place),
                     in_grad_placements=(q_place, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)
