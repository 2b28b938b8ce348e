"""Training launcher: ``--arch <id>`` selects a ported architecture.

The port of the JAX package's ``launch/train.py``, with its flags and its
printed lines, plus ``--device`` (default ``cuda``; without a card it raises
unless given ``--device cpu``). Runs REDUCED configs unless ``--full``; the
full ``qwen3-0.6b`` (596,049,920 parameters, bfloat16) trains on one H100,
its attention on the hand-written CUDA kernels both ways
(``kernels/flash_attention.py``). Includes checkpoint/resume, straggler
accounting and the fault-tolerant step loop (``training.train_loop``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b --full \\
      --batch 4 --seq-len 2048 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-mlperf --steps 50
  PYTHONPATH=src python -m repro_torch.launch.train --arch sm-cnn --device cpu

Families ``lm``, ``textpair`` (sm-cnn) and ``recsys`` (dlrm-mlperf, fm, din;
DLRM's lookups on the hand-written EmbeddingBag kernels both ways,
``kernels/embedding_bag.py``) train. BERT4Rec (from its ``loss_fn``) and the
``gnn`` family raise ``NotImplementedError``: their training comes with
ROADMAP.md §1 item 10e. ``--full`` dlrm-mlperf does not fit one card: its
24.03e9 table elements need 16 bytes each for the parameter, its float32
master copy and the two moments (384.5 GB), so it waits for the sharded
table of item 11. The data are the port's numpy generators with the JAX
launcher's seeds, so both launchers see the same batches; the weights are
drawn from ``torch.Generator`` seed 0 on the device, so they are not JAX's.
"""
from __future__ import annotations

import argparse
import functools

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.core.treepath import tree_leaves
from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
from repro_torch.training.train_loop import Trainer


def build(arch: str, full: bool, batch: int, seq_len: int, device="cuda"):
    """Returns (cfg, params, loss, data): the config (reduced unless
    ``full``), parameters on ``device``, ``loss(params, batch) -> (loss,
    metrics)`` and an endless iterator of numpy batches."""
    cfg = get_config(arch)
    if not full:
        cfg = reduced(cfg)
    fam = cfg.family
    dev = resolve_device(device)

    if fam == "lm":
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

    if fam != "textpair":
        raise NotImplementedError(
            f"{arch}: training of the {fam} family is not ported yet "
            f"(ROADMAP.md §1 item 10e)")

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
                    help="full config (qwen3-0.6b fits one 80 GB card; "
                         "dlrm-mlperf's 384.5 GB of state does not)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card cuda raises")
    args = ap.parse_args(argv)

    cfg, params, loss, data = build(args.arch, args.full, args.batch,
                                    args.seq_len, args.device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={args.arch} family={cfg.family} params={n_params:,}")
    opt = adamw(warmup_cosine_schedule(args.lr, 10, args.steps))
    tr = Trainer(loss, opt, params, ckpt_dir=args.ckpt_dir, ckpt_every=50)
    if args.ckpt_dir and tr.restore():
        print(f"resumed at step {tr.step}")
    metrics = tr.run(data, max_steps=args.steps, log_every=10)
    print("final:", {k: round(v, 4) for k, v in metrics.items()})


if __name__ == "__main__":
    main()
