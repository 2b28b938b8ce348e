#!/usr/bin/env python3
"""Count, on the CPU, the FLOPs of each step that ``chip_smoke.py`` reads
against its bound, and print the model-to-counted FLOP ratio (the useful
ratio ``repro_torch.roofline.analysis.build_roofline`` reports).

  PYTHONPATH=src python3 scripts/roofline_predict.py

Each program runs at full width under ``repro_torch.roofline.counts.count``
at a batch (or graph) cut down from the one the card runs. The counted and
the model FLOPs both grow in proportion to the batch, and a graph's to its
nodes and edges cut in one proportion, so the ratio is the card's. The
qwen3-0.6b steps at full width and S=2048 are too large for a CPU run; their
counted FLOPs are the port's products written out (the formulas the counter
adds up): every weight's product over the tokens that reach it, the
attention kernels' causal-half formulas and, for training, both gradients
of every product whose input needs one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES, TEXTPAIR_SHAPES,
                                 get_config)
from repro_torch.core import backends
from repro_torch.data import graph as G, recsys as rec_data
from repro_torch.models import gnn, recsys as rec, sm_cnn
from repro_torch.roofline import analysis, counts
from repro_torch.training.train_loop import value_and_grad


def _row(what: str, arch: str, shape, counted: float) -> None:
    model = analysis.model_flops(arch, shape)
    print(f"{what}: {shape.describe()}: model_flops {model:.6e}, counted "
          f"{counted:.6e} FLOPs, useful ratio {model / counted:.5f}")


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def pipeline(b: int = 16) -> None:
    """The pallas scorer (both arms through the conv wrapper) at bucket 256."""
    cfg = get_config("sm-cnn")
    scorer = backends.make_scorer("pallas", sm_cnn.init_sm_cnn_numpy(cfg, seed=0), cfg,
                                  buckets=(b,), device="cpu")
    rng = np.random.default_rng(0)
    rows = (rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32),
            rng.standard_normal((b, cfg.n_extra_feats)).astype(np.float32))
    shape = dataclasses.replace({s.name: s for s in TEXTPAIR_SHAPES}["pair_serve"], batch=256)
    _row("pipeline pallas scorer", "sm-cnn", shape, counts.count(scorer, *rows).flops * 256 / b)


def lm() -> None:
    """qwen3-0.6b: prefill 8 x 2048 (the head on the last position only)
    and a training step of 4 x 2048 (tied embeddings: the head's two
    gradients, no gradient of the token ids)."""
    cfg = get_config("qwen3-0.6b")
    d, L, h, hkv, dh = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    layer_w = d * h * dh * 2 + d * hkv * dh * 2 + 3 * d * cfg.d_ff
    head_w = cfg.vocab_padded * d
    shapes = {s.name: s for s in LM_SHAPES}
    b, s = 8, 2048
    attn = analysis.attention_work(b, s, h, hkv, dh, cfg.dtype)[0]
    prefill = 2 * b * s * L * layer_w + L * attn + 2 * b * head_w
    _row("lm prefill", cfg.name, dataclasses.replace(shapes["prefill_32k"], seq_len=s,
                                                     global_batch=b), prefill)
    b = 4
    attn = (analysis.attention_work(b, s, h, hkv, dh, cfg.dtype, lse=True)[0]
            + analysis.attention_bwd_work(b, s, h, hkv, dh, cfg.dtype)[0])
    train = 6 * b * s * (L * layer_w + head_w) + L * attn
    _row("lm-train", cfg.name, dataclasses.replace(shapes["train_4k"], seq_len=s,
                                                   global_batch=b), train)


def dlrm(b: int = 32) -> None:
    """dlrm-mlperf serve_bulk, and a training step's loss and gradients (the
    optimizer does no products); fields cut to 1,000 rows, which changes no
    product."""
    cfg = get_config("dlrm-mlperf")
    cut = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, 1000) for v in cfg.vocab_sizes),
                              dtype="float32")
    params = rec.init_model(cut, torch.Generator().manual_seed(0), "cpu")
    batch = _t(rec_data.batch_for(cut, b, seed=1))
    shapes = {s.name: s for s in RECSYS_SHAPES}
    with torch.no_grad():
        c = counts.count(rec.serve_step, params, batch, cut).flops
    bulk = shapes["serve_bulk"]
    _row("rec serve_bulk", cfg.name, bulk, c * bulk.batch / b)
    c = counts.count(value_and_grad, lambda p, x: rec.loss_fn(p, x, cut), params, batch).flops
    train = shapes["train_batch"]
    _row("rec-train", cfg.name, train, c * train.batch / b)


def bert4rec(b: int = 2, b_card: int = 16384) -> None:
    """BERT4Rec's loss and gradients at full width, 1,024 negatives."""
    cfg = dataclasses.replace(get_config("bert4rec"), dtype="float32")
    params = rec.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = _t(rec_data.batch_for(cfg, b, seed=1))
    c = counts.count(value_and_grad, lambda p, x: rec.loss_fn(p, x, cfg), params, batch).flops
    shape = dataclasses.replace({s.name: s for s in RECSYS_SHAPES}["train_batch"], batch=b_card)
    _row("bert4rec", "bert4rec", shape, c * b_card / b)


def meshgraphnet() -> None:
    """Each GNN step chip_smoke.py runs (remat on, as the config has it):
    molecule and full_graph_sm whole, minibatch_lg's sampled pads cut to a
    sixteenth in both nodes and edges."""
    cfg = dataclasses.replace(get_config("meshgraphnet"), dtype="float32")
    shapes = {s.name: s for s in GNN_SHAPES}

    def step(shape, batch, batched=False):
        params = gnn.init_gnn(cfg, torch.Generator().manual_seed(0), shape.d_feat, "cpu")
        return counts.count(value_and_grad,
                            lambda p, x: gnn.loss_fn(p, x, cfg, batched=batched), params,
                            _t(batch)).flops

    s = shapes["molecule"]
    _row("gnn molecule", "meshgraphnet", s, step(s, G.graph_batch(
        s.n_nodes, s.n_edges, s.d_feat, d_out=cfg.d_out, seed=0, n_graphs=s.n_graphs), True))
    s = shapes["full_graph_sm"]
    _row("gnn full_graph_sm", "meshgraphnet", s, step(s, G.graph_batch(
        s.n_nodes, s.n_edges, s.d_feat, d_out=cfg.d_out, seed=0)))
    s = shapes["minibatch_lg"]
    hops = [s.batch_nodes]
    for f in s.fanout:
        hops.append(hops[-1] * f)
    pads = dataclasses.replace(s, n_nodes=sum(hops), n_edges=sum(hops[1:]))
    small = dataclasses.replace(pads, n_nodes=pads.n_nodes // 16, n_edges=pads.n_edges // 16)
    _row("gnn minibatch_lg (pads / 16)", "meshgraphnet", small, step(small, G.graph_batch(
        small.n_nodes, small.n_edges, s.d_feat, d_out=cfg.d_out, seed=0)))


def main() -> None:
    torch.manual_seed(0)
    pipeline()
    lm()
    dlrm()
    bert4rec()
    meshgraphnet()


if __name__ == "__main__":
    main()
