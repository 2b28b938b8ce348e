"""Training launcher: ``--arch <id>`` selects a ported architecture.

The port of the JAX package's ``launch/train.py``, with its flags and its
printed lines, plus ``--device`` (default ``cuda``; without a card it raises
unless given ``--device cpu``). Runs REDUCED configs unless ``--full``; the
full ``qwen3-0.6b`` (596,049,920 parameters) and ``granite-3-2b``
(2,533,365,760 parameters, d_head 64), both bfloat16, train on one H100,
their attention on the hand-written CUDA kernels both ways
(``kernels/flash_attention.py``), each layer rematerialised (``cfg.remat``).
The reduced LM configs are float32 at d_head 16, for which no attention
kernel is compiled (``KERNEL_HEAD_DIMS``): on the card ``build`` gives them
``attn_impl="chunked"`` (``models/layers.causal_attention``, plain PyTorch)
and the launcher says so on a line of its own after the ``arch=`` line, for
example ``attn=chunked (no CUDA kernel for float32 d_head 16)``; a config
the kernels take keeps ``"flash"``, and on the CPU nothing changes.
``--full`` is the production setting: the ``Trainer`` donates, updating the
params and the optimizer state in place (``Trainer(donate=True)``, as the
JAX package asks of production launchers), so granite's 40.5 GB of bf16
params and grads and float32 moments and master copies are held once.
Includes checkpoint/resume, straggler accounting and the fault-tolerant step
loop (``training.train_loop``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-coder-33b --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-moe-16b --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --full \\
      --batch 4 --seq-len 2048 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --full \\
      --batch 4 --seq-len 2048 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch bert4rec --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch meshgraphnet --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch sm-cnn --device cpu

Every family trains: ``lm``, ``textpair`` (sm-cnn), ``recsys``
(dlrm-mlperf, fm, din, bert4rec; DLRM's and BERT4Rec's lookups on the
hand-written EmbeddingBag kernels both ways, ``kernels/embedding_bag.py``)
and ``gnn`` (meshgraphnet, on synthetic 200-node, 800-edge graphs with 16
node features, a new graph a step, as the JAX launcher builds them).
``--full`` dlrm-mlperf does not fit one card: its 24.03e9 table elements
need 16 bytes each for the parameter, its float32 master copy and the two
moments (384.5 GB), so it waits for the table sharded over more than one
card (the rules that shard it, ``distributed/sharding.py``, and the
planner, ``launch/specs.py``, are ported; multi-card cells are ROADMAP.md
§1 item 11's next step);
so does ``--full`` deepseek-coder-33b (3.334e10 parameters at 16
bytes each: 533 GB), whose reduced config trains here and whose full width
trains on one card only at a cut depth (``chip_smoke.py``'s lm-coder-train,
4 of its 62 layers). The MoE configs (deepseek-moe-16b,
moonshot-v1-16b-a3b) train their reduced configs here (float32 at d_head 16:
on the card on ``"chunked"``, with the ``attn=`` line) and print the summed
load-balance loss, ``moe_aux``, among the final metrics, as the JAX
launcher does; ``--full`` for them does not fit one card either:
deepseek-moe-16b's 1.688e10 parameters need 270 GB of training state and
moonshot-v1-16b-a3b's 2.889e10 need 462 GB, so they wait for more than one
card too (deepseek-moe-16b's full width trains on one card at 4 of its 28
layers in ``chip_smoke.py``'s lm-moe-train, and through the expert-parallel
``moe_apply_a2a`` at world size 1 in its lm-moe-a2a). The data are the port's numpy
generators with the JAX launcher's seeds, so both launchers see the same
batches; the weights are drawn from ``torch.Generator`` seed 0 on the
device, so they are not JAX's.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core.treepath import tree_leaves
from repro_torch.kernels import flash_attention as FA
from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
from repro_torch.training.train_loop import Trainer


def kernel_gap(cfg) -> Optional[str]:
    """Why the hand-written attention kernels cannot run an LM config both
    ways on the card, read from ``KERNEL_HEAD_DIMS`` for the config's dtype
    and d_head, or None where they can."""
    dtype = getattr(torch, cfg.dtype)
    for direction in ("forward", "backward"):
        if cfg.d_head not in FA.KERNEL_HEAD_DIMS[(direction, dtype)]:
            return f"no CUDA kernel for {cfg.dtype} d_head {cfg.d_head}"
    return None


def attention_impl(cfg, device_type: str) -> str:
    """The LM config's attention on ``device_type``: ``"chunked"`` where it
    asks for ``"flash"`` on the card and ``kernel_gap`` names a gap (the
    wrapper would raise there), else its own ``attn_impl``. Decided from the
    tables before anything is allocated, not by trying the kernel."""
    if device_type == "cuda" and cfg.attn_impl == "flash" and kernel_gap(cfg):
        return "chunked"
    return cfg.attn_impl


def build(arch: str, full: bool, batch: int, seq_len: int, device="cuda"):
    """Returns (cfg, params, loss, data): the config (reduced unless
    ``full``; an LM's attention as ``attention_impl`` picks it for the
    device), parameters on ``device``, ``loss(params, batch) -> (loss,
    metrics)`` and an endless iterator of numpy batches."""
    cfg = get_config(arch)
    if not full:
        cfg = reduced(cfg)
    fam = cfg.family
    dev = resolve_device(device)

    if fam == "lm":
        cfg = dataclasses.replace(cfg, attn_impl=attention_impl(cfg, dev.type))
        from repro_torch.data.lm import token_batches
        from repro_torch.models import transformer as tfm
        params = tfm.init_lm(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        loss = functools.partial(tfm.loss_fn, cfg=cfg)
        data = token_batches(cfg.vocab_size, batch, seq_len)
        return cfg, params, loss, data

    if fam == "recsys":
        from repro_torch.data.recsys import batches
        from repro_torch.models import recsys as rec_lib
        params = rec_lib.init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        loss = functools.partial(rec_lib.loss_fn, cfg=cfg)
        return cfg, params, loss, batches(cfg, batch)

    if fam == "gnn":
        from repro_torch.data.graph import graph_batch
        from repro_torch.models import gnn as gnn_lib
        d_feat = 16
        params = gnn_lib.init_gnn(cfg, torch.Generator(device=dev).manual_seed(0),
                                  d_feat, dev)
        loss = functools.partial(gnn_lib.loss_fn, cfg=cfg)

        def graphs():
            i = 0
            while True:
                yield graph_batch(200, 800, d_feat=d_feat, d_out=cfg.d_out, seed=i)
                i += 1
        return cfg, params, loss, graphs()

    # textpair (sm-cnn)
    from repro_torch.data import qa as QA
    from repro_torch.data.tokenizer import HashingTokenizer
    from repro_torch.models import sm_cnn
    corpus = QA.generate_corpus(n_docs=80, n_questions=60, seed=0)
    tok = HashingTokenizer(cfg.vocab_size)
    params = sm_cnn.init_sm_cnn(cfg, torch.Generator().manual_seed(0), dev)
    loss = functools.partial(sm_cnn.loss_fn, cfg=cfg)

    def pairs():
        ep = 0
        while True:
            yield from QA.pair_batches(corpus, tok, cfg.max_len, batch, seed=ep)
            ep += 1
    return cfg, params, loss, pairs()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCHS))
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--full", action="store_true",
                    help="full config, trained with donated (in-place) updates "
                         "(qwen3-0.6b and granite-3-2b fit one 80 GB card; "
                         "dlrm-mlperf's 384.5 GB, deepseek-coder-33b's 533 GB, "
                         "deepseek-moe-16b's 270 GB and moonshot-v1-16b-a3b's "
                         "462 GB of state do not)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card cuda raises")
    args = ap.parse_args(argv)

    cfg, params, loss, data = build(args.arch, args.full, args.batch,
                                    args.seq_len, args.device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={args.arch} family={cfg.family} params={n_params:,}")
    if cfg.family == "lm" and cfg.attn_impl != get_config(args.arch).attn_impl:
        print(f"attn={cfg.attn_impl} ({kernel_gap(cfg)})")
    opt = adamw(warmup_cosine_schedule(args.lr, 10, args.steps))
    tr = Trainer(loss, opt, params, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                 donate=args.full)
    if args.ckpt_dir and tr.restore():
        print(f"resumed at step {tr.step}")
    metrics = tr.run(data, max_steps=args.steps, log_every=10)
    print("final:", {k: round(v, 4) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
