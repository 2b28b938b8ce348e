"""Causal GQA attention forward: the attention of every LM prefill layer.

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

``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel; ``reset_launches`` sets it to 0. ``route_info``
reports what a dtype's kernel holds on the card (registers, spills, shared
memory, resident blocks).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

#: TPU kernel this replaces (file:line of its wrapper; body ``_kernel`` at
#: :24, ``pallas_call`` at :77)
REPLACES = "src/repro/kernels/flash_attention.py:63"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: head widths the CUDA kernel is compiled for (qwen3-0.6b's); the plain
#: version takes any width
KERNEL_HEAD_DIMS = (128,)
#: a block's query rows, positions x the query heads of one KV head: the
#: kernel takes a group size G = H / Hkv that divides it
KERNEL_ROWS = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: design stage of a route's kernel, as the C library reports it
STAGES = {0: "CUDA-core FMA", 2: "wgmma + TMA"}
#: the mask value: exp(-1e30 - m) is 0 without NaN, unlike -inf
MASK = -1e30

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


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
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    b, s, h, d = q.shape
    hkv = k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _kernel_fn()(_DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), out.data_ptr(), b, s, h, hkv, d,
                       1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} at B={b} S={s} H={h} Hkv={hkv} d={d} {q.dtype}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, S, H, d), (B, S, Hkv, d) x2 -> (B, S, H, d) in q's type, causal:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
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
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    index = q.device.index
    if index is None or index == torch.cuda.current_device():
        out = _launch(q, k, v)
    else:   # the kernel launches on the runtime's current device
        with torch.cuda.device(index):
            out = _launch(q, k, v)
    launches += 1
    return out
