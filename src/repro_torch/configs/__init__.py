"""Architecture registry: ``get_config("sm-cnn")`` resolves here.

The paper's own text-pair model and qwen3-0.6b of the LM family are ported
so far; the other architectures register here as their models are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES, LMConfig, MoESpec, ShapeSpec, TextPairConfig, reduced,
)

_MODULES = {
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "sm-cnn": "repro_torch.configs.sm_cnn",
}


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG

