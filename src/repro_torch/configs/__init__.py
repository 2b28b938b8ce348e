"""Architecture registry: ``get_config(arch)`` resolves here.

Every architecture of the JAX package's registry registers its full config
and its shape set, so ``roofline.analysis.model_flops`` covers each
(arch x shape) cell. ``ARCHS`` lists the ones the training launcher
offers: the paper's own text-pair model, qwen3-0.6b, granite-3-2b,
deepseek-coder-33b, deepseek-moe-16b and moonshot-v1-16b-a3b of the LM
family, dlrm-mlperf, fm, din and bert4rec of the recsys family and
meshgraphnet of the GNN family. granite-3-2b (d_head 64, tied embeddings)
serves and trains through ``models.transformer`` in bfloat16, on the
attention kernels' d=64 instances both ways (the float32 kernels take
d_head 128 only, so a float32 granite runs the plain attention or
nothing on the card). The MoE configs (deepseek-moe-16b,
moonshot-v1-16b-a3b) build, serve and train through ``models.transformer``
(``models/moe.py``; G=1, the attention kernels both ways), serving with the
bfloat16 KV cache or, under ``kv_quant``, the int8 one; their reduced
configs train through the launcher, and deepseek-moe-16b's full width on
one card only at a cut depth (all 28 layers' training state is about 270
GB, moonshot's 48 about 462 GB). Their expert-parallel MoE
(``models.moe.moe_apply_a2a``) and the sharding rules (``distributed/``)
are ported and run at world size 1, and the dry-run planner plans them
at 256 and 512 ranks; the full depths wait for more than one card
(ROADMAP.md §1 item 11).
deepseek-coder-33b (56 query heads over 8 KV heads: G=7) serves through
``models.transformer`` in bfloat16, on the attention forward kernel at that
group size, with the bfloat16 KV cache or, under ``kv_quant``, the int8
one, and trains on the attention kernels both ways at that group size: its
reduced config through the launcher, its full width on one card at a cut
depth (the 533 GB of training state of all 62 layers waits for more than
one card: ROADMAP.md §1 item 11).
"""
from __future__ import annotations

import importlib
from typing import List, Tuple

from repro_torch.configs.base import (  # noqa: F401
    CRITEO_VOCABS, GNN_SHAPES, GNNConfig, LM_SHAPES, LMConfig, MoESpec,
    RECSYS_SHAPES, RecsysConfig, ShapeSpec, TEXTPAIR_SHAPES, TextPairConfig, reduced,
)

_MODULES = {
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0_6b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "bert4rec": "repro_torch.configs.bert4rec",
    "fm": "repro_torch.configs.fm",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "din": "repro_torch.configs.din",
    "sm-cnn": "repro_torch.configs.sm_cnn",
}

ASSIGNED_ARCHS = tuple(a for a in _MODULES if a != "sm-cnn")
#: every architecture whose model is ported so far (the training
#: launcher's ``--arch`` choices)
ARCHS = ("bert4rec", "deepseek-coder-33b", "deepseek-moe-16b", "din", "dlrm-mlperf", "fm",
         "granite-3-2b", "meshgraphnet", "moonshot-v1-16b-a3b", "qwen3-0.6b", "sm-cnn")


def get_config(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def get_shapes(arch: str) -> Tuple[ShapeSpec, ...]:
    return tuple(importlib.import_module(_MODULES[arch]).SHAPES)


def shape_applicable(cfg, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether a (arch, shape) cell is runnable, and if not, why (skip note)."""
    if getattr(cfg, "family", "") == "lm" and shape.kind == "long_decode":
        if not cfg.sub_quadratic:
            return False, ("pure full-attention arch: 512k-token KV decode is "
                           "skipped per assignment rule (needs sub-quadratic "
                           "attention); see DESIGN.md §Arch-applicability")
    return True, ""


def cells(include_inapplicable: bool = False) -> List[Tuple[str, ShapeSpec]]:
    """All assigned (arch, shape) cells (40 incl. skipped long_500k rows)."""
    out = []
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in get_shapes(arch):
            ok, _ = shape_applicable(cfg, shape)
            if ok or include_inapplicable:
                out.append((arch, shape))
    return out
