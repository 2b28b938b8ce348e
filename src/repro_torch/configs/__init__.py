"""Architecture registry: ``get_config("sm-cnn")`` resolves here.

Only the paper's own text-pair model is ported so far; the other families
register here as their models are ported.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import TextPairConfig, reduced  # noqa: F401

_MODULES = {
    "sm-cnn": "repro_torch.configs.sm_cnn",
}


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG

