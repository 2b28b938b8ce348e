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
  ``cp.async``). The work is bound by operations: 1.375e11 at B=8, S=2048
  (H=16, Hkv=8, d=128), 0.139 ms at the card's 989 TFLOP/s.
* float32: the CUDA-core kernel, because float32 is held to 2e-5, which
  the tensor cores' TF32 (about three decimal digits) cannot meet.

Query head ``h`` attends with KV head ``h // G`` (``G = H / Hkv``). Any
``S >= 1`` works: the kernel masks the ragged tail itself, where the Pallas
kernel asserted ``S % block == 0``. It reads and writes the
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
forward; float32 on the CUDA cores), on CPU tensors in
``flash_attention_bwd_plain``. Serving runs under ``torch.inference_mode()``
and keeps the forward with no ``lse`` written.

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

from repro_torch.kernels import build

#: TPU kernel this replaces (file:line of its wrapper; body ``_kernel`` at
#: :24, ``pallas_call`` at :77)
REPLACES = "src/repro/kernels/flash_attention.py:63"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: the gradient's JAX twin: the backward rule of flash_attention_jnp's
#: custom VJP (the TPU kernel itself has no backward)
BWD_REPLACES = "src/repro/models/layers.py:235"
BWD_SOURCE = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
#: head widths the CUDA kernel is compiled for (qwen3-0.6b's); the plain
#: version takes any width
KERNEL_HEAD_DIMS = (128,)
#: a block's query rows, positions x the query heads of one KV head: the
#: kernel takes a group size G = H / Hkv that divides it
KERNEL_ROWS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: design stage of a route's kernel, as the C library reports it
STAGES = {0: "CUDA-core FMA", 2: "wgmma + TMA"}
#: design of the backward's kernels, as the C library reports it
BWD_DESIGNS = {0: "CUDA-core FMA", 2: "wgmma + TMA"}
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
    (lse log2 e, delta), a (batch row, KV head)'s S x G rows padded to 128
    (``STAT_ROWS`` of ``csrc/flash_attention_bwd.cu``, which refuses a
    smaller scratch); float32 uses the first B x H x S for delta."""
    return 2 * b * hkv * (-(-s * (h // hkv) // 128) * 128)


def route_info(dtype: torch.dtype) -> dict:
    """The CUDA kernel that serves ``dtype`` on the current card: its design
    stage, registers and local (spill) bytes a thread, static and dynamic
    shared memory a block, blocks resident on an SM and threads a block,
    from the CUDA runtime (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    fn = build.load_library("flash_attention").flash_attention_route_info
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * 7)()
    err = fn(_DTYPE_CODES[dtype], info)
    if err != 0:
        raise RuntimeError(f"flash_attention_route_info failed: CUDA error {err}")
    keys = ("stage", "registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads")
    out = dict(zip(keys, info))
    out["design"] = STAGES[out["stage"]]
    return out


def bwd_route_info(dtype: torch.dtype) -> dict:
    """The backward's two kernels for ``dtype`` on the current card, as
    ``{"dkdv": {...}, "dq": {...}}``: registers and local (spill) bytes a
    thread, static and dynamic shared memory a block, blocks resident on an
    SM, threads a block and the design (bfloat16: ``wgmma`` + TMA on the
    tensor cores, 384 threads; float32: CUDA-core FMAs, 256 threads)."""
    fn = build.load_library("flash_attention_bwd").flash_attention_bwd_route_info
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads", "design")
    out = {}
    for which, name in enumerate(("dkdv", "dq")):
        info = (ctypes.c_int * 7)()
        err = fn(_DTYPE_CODES[dtype], which, info)
        if err != 0:
            raise RuntimeError(f"flash_attention_bwd_route_info failed: CUDA error {err}")
        out[name] = dict(zip(keys, info))
        out[name]["design"] = BWD_DESIGNS[out[name]["design"]]
    return out


def _check_kernel(*tensors: torch.Tensor) -> None:
    """What the CUDA kernels take beyond ``_check``: q, k, v (and, for the
    backward, out and dout) on the card, d=128, G dividing 128, B and Hkv
    within the grid, each tensor on a 16-byte boundary."""
    q, k = tensors[0], tensors[1]
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, s, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is compiled for head widths "
                         f"{KERNEL_HEAD_DIMS}, not {d}")
    if KERNEL_ROWS % (h // k.shape[2]):
        raise ValueError(f"the CUDA kernel takes a number of query heads per KV "
                         f"head that divides {KERNEL_ROWS}, not {h // k.shape[2]}")
    if b > 65535 or k.shape[2] > 65535:
        raise ValueError(f"the CUDA kernel's grid takes B and Hkv up to 65535, "
                         f"not B={b} Hkv={k.shape[2]}")
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
            with_lse: bool = False):
    """The forward kernel: ``out``, and with ``with_lse`` also ``lse``
    (B, H, S) float32."""
    global launches
    b, s, h, d = q.shape
    hkv = k.shape[2]
    out = torch.empty_like(q)
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
                lse: torch.Tensor, dout: torch.Tensor):
    """The backward kernels: ``(dq, dk, dv)``."""
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
    _check_kernel(q, k, v, out, dout, lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # float32 scratch for each row's delta (bfloat16: with its lse, in the
    # kernels' row order)
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
        if q.device.type == "cpu":
            out, lse = flash_attention_fwd_plain(q, k, v)
        else:
            out, lse = _launch(q, k, v, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()   # autograd may hand over a strided gradient
        if q.device.type == "cpu":
            return flash_attention_bwd_plain(q, k, v, out, lse, dout)
        return _launch_bwd(q, k, v, out, lse, dout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d), (B, S, Hkv, d) x2 -> (B, S, H, d) in q's type, causal:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors. Where
    grad is enabled and an input requires it, through ``FlashAttention``,
    whose backward is the CUDA backward kernel (the plain backward on CPU
    tensors)."""
    _check(q, k, v)
    if q.device.type != "cpu":
        _check_kernel(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    return _launch(q, k, v)
