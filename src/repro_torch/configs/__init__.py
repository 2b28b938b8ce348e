"""Architecture registry: ``get_config("sm-cnn")`` resolves here.

The paper's own text-pair model, qwen3-0.6b of the LM family and
dlrm-mlperf, fm and din of the recsys family are ported so far; the other
architectures register here as their models are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    CRITEO_VOCABS, LM_SHAPES, LMConfig, MoESpec, RECSYS_SHAPES, RecsysConfig,
    ShapeSpec, TextPairConfig, reduced,
)

_MODULES = {
    "din": "repro_torch.configs.din",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "fm": "repro_torch.configs.fm",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "sm-cnn": "repro_torch.configs.sm_cnn",
}
#: every architecture ported so far
ARCHS = tuple(sorted(_MODULES))


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG

