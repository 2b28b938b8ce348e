"""Target hardware constants: one NVIDIA H100 SXM (80 GB HBM3), from
NVIDIA's data sheet, dense rates without sparsity, at the full power limit
of 700 W. A card set below 700 W runs slower under load, so a share read
against these rates states the card's power limit beside it."""
from __future__ import annotations

from typing import Union

import torch

#: products on the tensor cores, FLOP/s, by operand type
TENSOR_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12}
#: TF32 products on the tensor cores, FLOP/s
TF32_FLOPS = 495e12
#: float32 on the CUDA cores, FLOP/s
F32_FLOPS = 67e12
HBM_BW = 3.35e12              # bytes/s
#: NVLink 4 per GPU, one direction (900 GB/s both ways); unused at world size 1
NVLINK_BW = 450e9             # bytes/s

DTYPE_BYTES = {
    torch.bool: 1, torch.uint8: 1, torch.int8: 1,
    torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.int16: 2, torch.float16: 2, torch.bfloat16: 2,
    torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}


def as_dtype(dtype: Union[torch.dtype, str]) -> torch.dtype:
    """A ``torch.dtype`` from itself or its name (a config's ``dtype``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, dtype, None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"not a torch dtype: {dtype!r}")
    return out


def peak_flops(dtype: Union[torch.dtype, str], products: bool = True) -> float:
    """The card's peak rate for work in ``dtype``, FLOP/s.

    Products (``products=True``) in bf16 and fp16 take the tensor cores'
    rate. A float32 product takes the larger of the CUDA
    cores' 67e12 and a third of the TF32 rate, 495e12 / 3 = 165e12: in
    3xTF32 each operand splits into a TF32 high and low part and
    hi*hi + hi*lo + lo*hi, summed in float32, is float32-accurate, so three
    TF32 products do one float32 product's work, faster than the CUDA
    cores. Other float32 work (adds, elementwise) keeps 67e12, and
    ``products=False`` gives the CUDA cores' rate for any type."""
    dt = as_dtype(dtype)
    if not products:
        return F32_FLOPS
    if dt == torch.float32:
        return max(F32_FLOPS, TF32_FLOPS / 3)
    if dt in TENSOR_FLOPS:
        return TENSOR_FLOPS[dt]
    raise ValueError(f"no peak rate for products in {dt}")
