"""The SM-CNN's fused conv arm: wide conv1d + bias + tanh + global max-pool.

  x_emb (B, S, d), filters (w*d, F) in the im2col layout, bias (F,) -> (B, F)

``conv_tanh_maxpool`` is the wrapper the model calls. A CUDA tensor goes to
the hand-written Hopper kernel in ``csrc/sm_cnn_conv.cu`` (the port of the
TPU kernel ``src/repro/kernels/sm_cnn_conv.py:46``), built on first use and
bound with ``ctypes``; a CPU tensor goes to ``conv_tanh_maxpool_plain``, the
plain PyTorch version of the same function. There is no other route: a CUDA
call launches the kernel or raises.

The C entry point picks a kernel by dtype:

* float32, the main path's: the products on the tensor cores in three TF32
  passes (3xTF32: each operand split into a TF32 ``hi`` and ``lo``, summing
  ``lo*hi + hi*lo + hi*hi`` in float32, ~1e-6 from float32 where one TF32
  pass is ~1e-4 off), ``mma.sync`` m16n8k8, the filter bank staged in
  shared memory once per persistent block and each sample by ``cp.async``
  (the copy engine's bulk copies where a sample and a tap are whole
  16-byte chunks, as on the main path; else 4-byte copies) while the one
  before it computes. Non-finite inputs follow float32: only the ``hi*hi``
  pass carries inf and NaN.
* bfloat16: the CUDA-core kernel (float32 FMAs, one block a sample).

Both propagate NaN through the max over windows, as ``jnp.max`` does. A
shape whose staged operands do not fit a block's shared memory raises
``ValueError`` (at sm-cnn's S=64, d=50, F=100 the float32 kernel takes
157,408 of the 232,448 bytes an H100 allows a block; at that d and F it
takes S up to 180, the bfloat16 kernel S up to 1,016).

``launches`` counts the kernel's launches, so a run can show that its path
went through the kernel (under a lock: a server's workers call the
wrapper from many threads at once); ``reset_launches`` sets it to 0. ``route_info``
reports what a dtype's kernel holds on the card (design, registers, spills,
shared memory, resident blocks).
"""
from __future__ import annotations

import ctypes
import functools
# Lock by name, not threading.Lock(): the runtime lock sanitizer's static
# identity map (analysis/sanitizer.py) is of the JAX package's locks only.
from threading import Lock

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.roofline import analysis, counts

#: TPU kernel this replaces (file:line of its wrapper; body ``_kernel`` at :27)
REPLACES = "src/repro/kernels/sm_cnn_conv.py:46"
SOURCE = "src/repro_torch/kernels/csrc/sm_cnn_conv.cu"
#: filter widths the CUDA kernel is compiled for (sm-cnn's); the plain
#: version takes any width
KERNEL_WIDTHS = (5,)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: design stage of a route's kernel, as the C library reports it
STAGES = {0: "CUDA-core FMA", 1: "3xTF32 mma.sync + cp.async"}

launches = 0
_counting = Lock()


def reset_launches() -> None:
    global launches
    with _counting:
        launches = 0


def conv_tanh_maxpool_plain(x_emb: torch.Tensor, filters: torch.Tensor,
                            bias: torch.Tensor, width: int) -> torch.Tensor:
    """Pad w-1 on both sides, im2col, one matmul summed in float32, + bias,
    tanh, max over all S+w-1 windows; the result in the input's type."""
    s = x_emb.shape[1]
    pad = width - 1
    xp = F.pad(x_emb, (0, 0, pad, pad))
    n_win = s + width - 1
    cols = torch.cat([xp[:, i:i + n_win, :] for i in range(width)], dim=-1)
    h = torch.tanh(cols.float() @ filters.float() + bias.float())
    return h.amax(dim=1).to(x_emb.dtype)


def _check(x_emb: torch.Tensor, filters: torch.Tensor, bias: torch.Tensor,
           width: int) -> None:
    if x_emb.dim() != 3:
        raise ValueError(f"x_emb must be (B, S, d), got shape {tuple(x_emb.shape)}")
    if x_emb.dtype not in _DTYPE_CODES:
        raise TypeError(f"x_emb dtype {x_emb.dtype} not supported "
                        f"(float32 or bfloat16)")
    if filters.dtype != x_emb.dtype or bias.dtype != x_emb.dtype:
        raise TypeError(f"dtypes differ: x_emb {x_emb.dtype}, filters "
                        f"{filters.dtype}, bias {bias.dtype}")
    if width < 1:
        raise ValueError(f"filter width {width} is not positive")
    b, s, d = x_emb.shape
    if filters.dim() != 2 or filters.shape[0] != width * d:
        raise ValueError(f"filters must be (w*d, F) = ({width * d}, F), "
                         f"got {tuple(filters.shape)}")
    if tuple(bias.shape) != (filters.shape[1],):
        raise ValueError(f"bias must be ({filters.shape[1]},), got "
                         f"{tuple(bias.shape)}")
    if not (x_emb.device == filters.device == bias.device):
        raise ValueError(f"devices differ: x_emb {x_emb.device}, filters "
                         f"{filters.device}, bias {bias.device}")
    for name, t in (("x_emb", x_emb), ("filters", filters), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if b == 0 or s == 0:
        raise ValueError(f"empty input: x_emb shape {tuple(x_emb.shape)}")


def _kernel_fn():
    fn = build.load_library("sm_cnn_conv").sm_cnn_conv_tanh_maxpool
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def route_info(dtype: torch.dtype, s: int = 64, d: int = 50, f: int = 100) -> dict:
    """The CUDA kernel that serves ``dtype`` on the current card at filter
    width 5 and (S, d, F), sm-cnn's by default: its design stage, registers
    and local (spill) bytes a thread, static and dynamic shared memory a
    block, blocks resident on an SM (0 where the card cannot hold a block)
    and threads a block, from the CUDA runtime (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); and the card's most
    shared memory a block and SMs."""
    return dict(_route_info(dtype, s, d, f, torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _route_info(dtype: torch.dtype, s: int, d: int, f: int, device: int) -> dict:
    """``route_info`` on card ``device``, the current one; cached, so that a
    launch asks the runtime nothing once its shape has been seen."""
    fn = build.load_library("sm_cnn_conv").sm_cnn_conv_route_info
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    info = (ctypes.c_int * 9)()
    err = fn(_DTYPE_CODES[dtype], s, d, f, info)
    if err != 0:
        raise RuntimeError(f"sm_cnn_conv_route_info failed: CUDA error {err}")
    keys = ("stage", "registers", "local_bytes", "static_smem", "dynamic_smem",
            "blocks_per_sm", "threads", "smem_limit", "sms")
    out = dict(zip(keys, info))
    out["design"] = STAGES[out["stage"]]
    return out


def _launch(x_emb: torch.Tensor, filters: torch.Tensor, bias: torch.Tensor,
            width: int) -> torch.Tensor:
    b, s, d = x_emb.shape
    f = filters.shape[1]
    info = _route_info(x_emb.dtype, s, d, f, torch.cuda.current_device())
    need = info["static_smem"] + info["dynamic_smem"]
    if need > info["smem_limit"]:
        raise ValueError(f"the {x_emb.dtype} CUDA kernel needs {need} bytes of shared "
                         f"memory a block at S={s} d={d} F={f}; the card allows "
                         f"{info['smem_limit']}")
    out = torch.empty((b, f), dtype=x_emb.dtype, device=x_emb.device)
    stream = torch.cuda.current_stream(x_emb.device).cuda_stream
    err = _kernel_fn()(_DTYPE_CODES[x_emb.dtype], x_emb.data_ptr(),
                       filters.data_ptr(), bias.data_ptr(), out.data_ptr(),
                       b, s, d, width, f, info["sms"] * info["blocks_per_sm"], stream)
    if err != 0:
        raise RuntimeError(f"conv_tanh_maxpool kernel launch failed: CUDA "
                           f"error {err} at B={b} S={s} d={d} w={width} F={f} "
                           f"{x_emb.dtype}")
    return out


def conv_tanh_maxpool(x_emb: torch.Tensor, filters: torch.Tensor,
                      bias: torch.Tensor, width: int) -> torch.Tensor:
    """(B, S, d), (w*d, F), (F,) -> (B, F) in the input's type: the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor. Under a
    ``roofline.counts`` counter either route counts as
    ``analysis.conv_tanh_maxpool_work``."""
    global launches
    _check(x_emb, filters, bias, width)
    b, s, d = x_emb.shape
    with counts.kernel(lambda: analysis.conv_tanh_maxpool_work(
            b, s, d, width, filters.shape[1], x_emb.dtype)):
        if x_emb.device.type == "cpu":
            return conv_tanh_maxpool_plain(x_emb, filters, bias, width)
        if x_emb.device.type != "cuda":
            raise ValueError(f"no kernel for device {x_emb.device}")
        if width not in KERNEL_WIDTHS:
            raise ValueError(f"the CUDA kernel is compiled for filter widths "
                             f"{KERNEL_WIDTHS}, not {width}")
        index = x_emb.device.index
        if index is None or index == torch.cuda.current_device():
            out = _launch(x_emb, filters, bias, width)
        else:   # the kernel launches on the runtime's current device
            with torch.cuda.device(index):
                out = _launch(x_emb, filters, bias, width)
        with _counting:
            launches += 1
        return out
