#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

  python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:

  device    the card's name and power limit (nvidia-smi), versions; TF32
            off for matmul and cuDNN, so float32 is compared in float32
  build     nvcc builds every kernel of the port from src/repro_torch/
            kernels/csrc, one nvcc per source, all started together
            (ptxas register and spill report printed)
  kernel    the conv kernel against its plain PyTorch version on the card
            at every shape the main path gives it, the launcher world's
            scorer buckets among them (and a ragged and a small
            one, and shapes that cross the float32 kernel's tile edges), in
            float32 and bfloat16; with NaN and +-inf in the inputs at B=256
            (NaN positions equal, +-inf giving +-1); each route's design
            stage, registers, spills, shared memory and blocks resident on
            an SM; then its time from CUDA events, the plain version's, one
            PyTorch library call's as a yardstick, and the bound the card's
            data-sheet rates put on the same work (float32: on the CUDA
            cores and in 3xTF32 on the tensor cores)
  pipeline  the paper's system at the full width of sm-cnn (weights from
            --seed): Retrieve(h=20) >> Rerank("pallas") % 10 planned on the
            card through PlanContext + plan, `local` on 32 queries and
            `batched` on 256; the kernel's launch counter is set to 0 just
            before and read just after, and must show 2 launches per pallas
            scorer call; then local == batched (verify_plans), pallas ==
            eager rankings, pallas scores == a CPU eager scorer, q/s, p50,
            p99, per-stage spans and the device's busy share of one batch
  backends  the paper's integration strategies (its Table 1) at the full
            width of sm-cnn, same weights and corpus: for each of eager, jit,
            aot, numpy, pallas and artifact over buckets (1, 8, 64, 256),
            make_scorer's build seconds; each bucket's scores against eager
            on the card (rtol 1e-4, atol 1e-5); p50/p99 of each bucket's
            scorer call (host clock, as Scorer times it) and rows/s; the
            conv kernel's launch counter over the timed calls (2 a call for
            pallas, 0 for the others); jit compiles one program a bucket and
            never again, aot and artifact nothing after make_scorer
            (dynamo's graph counter and the scorer's own), aot replays one
            CUDA graph a call. Then Retrieve(h=20) >> Rerank(backend) % 10
            through both plans: batched q/s over the first 64 questions,
            local p50/p99 over 32, nothing compiled while timed, the top 10
            against eager's (neighbours may swap only where eager's scores
            are within 2e-5; the swaps are counted)
  service   the paper's service strategy (its Table 2) on the card, with the
            backends phase's scorers: 300 get_score RPCs from one client to
            a SimpleServer over a QuestionAnsweringHandler for pallas, jit,
            aot and numpy (q/s, p50/p99, the overhead: RPC p50 less the
            same handler's in-process p50 in the same run, and less the
            backends phase's bucket-1 scorer p50); every RPC score
            against the same handler in process (rtol 1e-4, atol 1e-5); the
            conv's launch counter set to 0 before and read after: 2 a pallas
            RPC, 0 for the others; each backend again behind a
            ThreadPoolServer under 8 client threads, each with pairs of its
            own, every reply against its pair's score in process (a scorer
            that mixed concurrent calls up would answer with another
            client's score); then a ServingEngine (max_batch 64,
            max_wait 1 ms) behind a ThreadPoolServer under 8 client threads
            (q/s, p50/p99, mean batch); Retrieve(h=20) >> Rerank("pallas")
            % 10 planned local, remote (a ThreadPoolServer over a handler)
            and remote_pipeline (a ThreadPoolServer over a PipelineEngine)
            ranking 64 questions alike (verify_plans); a past deadline shed
            as ShedError; a drain reaching 0 in flight
  launch    the serving launcher's stack (repro_torch.launch, training,
            serving.cluster/rollout/fabric) on the card: full-width sm-cnn
            trained 60 steps of batch 64 (Trainer + adamw) on the pipeline
            phase's corpus, the loss falling, the trained weights served by
            pallas == eager (rtol 1e-4, atol 1e-5), a checkpoint written
            from the card restored on the CPU bit-equal and published to a
            registry, build_world()'s seconds; ReplicaPools of 2 pallas and
            2 aot replicas behind a ThreadPoolServer under 8 client threads
            with pairs of their own, every reply against its pair's eager
            score in process, the conv launched 2 times a pallas scorer
            call (counter set to 0 before, read after), q/s and p50/p99
            beside the service phase's one-scorer rows; ShadowEngine and
            ABEngine between the seed and the trained registry versions,
            every reply the ranking of the version its arm names, and
            RolloutController.hot_swap through MSG_SWAP on a live server
            (a NaN version rolled back, the trained one landed); python -m
            repro_torch.launch.serve --describe --device cuda, then a
            --serve-pipeline --server threadpool --backend pallas server
            ranked through Client.rank_batch and drained with --drain; the
            launcher's world published to a registry and served by one
            in-process ThreadPoolServer, then by Fabric(n_workers=1) and
            Fabric(n_workers=4) (pallas on the card), each worker's and
            every router reply's rankings == the in-process pallas plan on
            that version, q/s and p50/p99 under 8 client threads, start-up
            seconds
  attn-kernel  the causal GQA attention kernel against its plain version
            at qwen3-0.6b's H=16, Hkv=8, d=128 for (B, S) from (1, 1) to
            (1, 4096), float32 and bfloat16 (randn inputs), by max absolute
            error and by the error's norm over the output's; then at the LM
            phase's prefills (8 x 2048 both types, 1 x 32768 bfloat16): the
            same checks (at 32768 on the first and last 256 query rows
            against all keys, where the plain version's full scores would
            not fit), SDPA as a yardstick held against the kernel, times of
            the kernel, the plain version where it fits and SDPA, the bound;
            bfloat16 also at B=2 for S around the 64-key tiles (63 .. 191),
            where a tile crosses the diagonal; first each route's design
            stage (bfloat16: mma.sync or wgmma; float32: CUDA cores),
            registers, spills, shared memory and blocks resident on an SM
  lm-check  the LM path in float32 against itself: prefill through the
            kernel ("flash") == plain torch ("chunked"), logits and cache;
            decode at position S == forward over S+1 tokens
  lm        qwen3-0.6b at full width in bfloat16 (weights from --seed,
            tokens from data/lm.py): prefill 8 x 2048, 32 greedy decode
            steps on the copied cache, prefill 1 x 32768; the attention
            kernel's launch counter is set to 0 just before and read just
            after, and must show 28 launches per prefill and none in
            decode; prefill tokens/s, decode ms per step, busy shares and
            the attention kernel's share of a prefill's device time
  attn-bwd  the attention's backward kernel (csrc/flash_attention_bwd.cu)
            against the plain backward at qwen3-0.6b's H=16, Hkv=8, d=128,
            float32 and bfloat16 (randn inputs and incoming gradient), for
            (B, S) from (1, 1) to (1, 1024) and S around the 64-key and
            64-row tiles and the bfloat16 kernels' 128-key and 128-row
            blocks (63 .. 257): dq, dk, dv by max absolute error (atol +
            rtol |want|) and by the error's norm; the forward kernel's lse
            against the plain lse; each backward kernel's registers,
            spills, shared memory and blocks resident on an SM; times at
            B=4 and B=8 x 2048 in bfloat16 of the kernel, the plain
            backward and SDPA's backward (the yardstick, held against the
            kernel), the bound, two calls bit-equal (no atomics), and the
            forward with its lse against without, the plain forward with
            its lse and SDPA's forward with grad on; the float32 backward
            timed at 4 x 2048 with SDPA's float32 backward
  lm-train  qwen3-0.6b's training path: float32 at full width cut to 2
            layers, the loss and every gradient leaf through the kernels
            ("flash") against plain autograd ("chunked"), every leaf
            nonzero; then the full-width bfloat16 model from
            launch.train.build(full=True) trained 20 steps of 4 x 2048
            through Trainer + adamw; both attention counters set to 0 just
            before and read just after: 28 forward and 28 backward launches
            a step; the loss falls; step ms, tokens/s, peak memory, the
            step's share of its bound, busy share and the attention's share
            of a step's device time; then python -m
            repro_torch.launch.train --arch qwen3-0.6b --full --steps 3
            --batch 2 --seq-len 512 --device cuda exiting 0
  bag-kernel  the EmbeddingBag kernel against its plain version: at
            tests/test_kernels.py's shapes and a ragged bag count, float32
            and bfloat16, with and without weights; ids outside the table
            (-1, -V, V, -V-1: jnp.take's wrap, and a NaN bag outside
            [-V, V)), NaN positions equal; in float32 over a
            20M-row table (past 2^31 elements) at the serve shapes' bag
            counts with ids from its last 10% of rows, and multi-hot; then
            dlrm-mlperf's full table (187,767,808 x 128 bfloat16, 48.07 GB,
            drawn from --seed on the card) at serve_p99 and serve_bulk with
            ids from data/recsys.py and from its last 10% of rows, and
            multi-hot (B=16384, L=32) with and without weights; times of
            the kernel, the plain version and F.embedding_bag (the
            yardstick) at both serve shapes and the multi-hot one, and the
            bound
  rec-check dlrm-mlperf in bfloat16: serve_step and retrieval_step through
            the kernel == through the plain version (torch.equal: a bag of
            one row is its row)
  rec       dlrm-mlperf at full width in bfloat16, batches from
            data/recsys.py: serve_p99 (B=512, p50/p99 of 64 steps),
            serve_bulk (B=262144, examples/s, median of 3), retrieval_cand
            (1,000,000 candidates, median of 5); the bag kernel's launch
            counter is set to 0 just before and read just after, and must
            show 1 launch per serve_step and 2 per retrieval_step; peak
            memory, the busy share of one serve_bulk step; then the 48 GB
            table is freed
  bag-bwd   the EmbeddingBag backward kernel (csrc/embedding_bag_bwd.cu)
            against its plain version, bit for bit, float32 and bfloat16,
            with and without weights: at the bag-kernel phase's shapes, a
            3-row field named 65,536 times, ids -1, -V, V, -V-1 (wrapped or
            dropped), a float32 gradient of 20M rows (past 2^31 elements);
            then dlrm-mlperf's training lookup (65,536 x 26 bags of one row,
            bfloat16, each field cut to 1,000,000 rows: V = 7,110,656): two
            calls bit-equal, times of the kernel, its sort, the plain
            version and aten.embedding_dense_backward (the yardstick), the
            bound
  rec-train dlrm-mlperf's training path, bfloat16, every width full and
            each field cut to 1,000,000 rows (the MLPerf DLRM reference's
            --max-ind-range): 20 steps of Trainer + adamw (the launcher's
            schedule) at batch 65,536 from data/recsys.py seed 0; both bag
            counters set to 0 just before and read just after: one forward
            and one backward launch a step; the loss falls; step ms,
            examples/s, peak memory, the step's share of its bound, busy
            share; the gradient tree through the kernels == through the
            plain route (torch.equal, B=512); reduced(dlrm-mlperf) float32
            loss and every gradient leaf on the card against the CPU;
            python -m repro_torch.launch.train --arch dlrm-mlperf --steps 3
            --device cuda exiting 0
  rec-family  FM and DIN at full width in bfloat16: serve_step at B=512 and
            262,144, retrieval_step over 1,000,000 candidates, 5 training
            steps at 65,536 (ms of each, peak memory); reduced float32
            serve, retrieval, loss and gradients on the card against the CPU

The attn-kernel, lm-check, lm, bag-kernel, rec-check and rec phases run
under torch.inference_mode(); attn-bwd, lm-train, bag-bwd, rec-train and
rec-family differentiate, outside it (their serving steps under it).
A kernel's "ms" is the mean over calls between two CUDA events with the
host issuing each call; its "device ms" is the same calls queued behind a
spin kernel, so that they run back to back on the card. Busy shares and
the attention backward's split by kernel come from torch.profiler, which
late in the run loses kernel records: a busy share says how many it saw
for how many launches, and a split counts only a session that saw all.
It prints one `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {...}}`. Any failed check raises and ends the run
with a nonzero exit; without a card, or without the repository's sources
beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import queue
import statistics
import subprocess
import sys
import threading
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data-sheet rates (NVIDIA's published dense peaks)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
#: dense TF32 on the tensor cores: float32-accurate work in 3xTF32 takes
#: three of its products for each float32 one
TF32_FLOPS = 495e12
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
#: kernel batch sizes: the scorer buckets of both plans (1..4096) and a
#: ragged one; S, d, w, F are sm-cnn's
KERNEL_BATCHES = (1, 3, 8, 64, 256, 1024, 4096)
#: (B, S, d, w, F) across the float32 kernel's tile edges: S=1 (5 windows),
#: S=13 (17 windows, not a multiple of 8 or 16), F around 8 and past 104 and
#: 112 (filter tiles of 16, the bank padded to 8), d around the k8 pad, more
#: samples than 132 SMs hold blocks; S past one chunk of 9 window tiles (69:
#: two, 141: three) up to the longest S its shared memory takes (180)
KERNEL_EDGE_SHAPES = ((4, 1, 50, 5, 100), (4, 13, 50, 5, 100), (4, 64, 50, 5, 8),
                      (4, 64, 50, 5, 9), (4, 64, 50, 5, 105), (4, 64, 50, 5, 113),
                      (4, 64, 8, 5, 100), (4, 64, 57, 5, 100), (133, 64, 50, 5, 100),
                      (4, 69, 50, 5, 100), (2, 141, 50, 5, 100), (2, 180, 50, 5, 100))
TIMED_BATCHES = (256, 4096)
TIE_ATOL = 1e-5
#: the host's kernel launch calls as torch.profiler names them
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx"))
#: tries of a back-to-back timing (_queued_ms), and profiler sessions of a
#: split by kernel (_profiled_split_ms)
QUEUE_ATTEMPTS = 6
PROFILE_ATTEMPTS = 8
#: every kernel of the port's paths (csrc/<name>.cu)
KERNELS = ("sm_cnn_conv", "flash_attention", "embedding_bag", "flash_attention_bwd",
           "embedding_bag_bwd")
#: the attention kernel against its plain version: tests/test_kernels.py's
#: tolerances for it, and (B, S) at qwen3-0.6b's H=16, Hkv=8, d=128, from
#: one token through ragged lengths to the largest S whose plain version
#: fits (its (1, 16, 4096, 4096) float32 scores take 1.07 GB)
ATTN_TOLERANCE = {"float32": 2e-5, "bfloat16": 3e-2}
#: and, since randn outputs shrink with S (about sqrt(e / S): 0.036 at
#: S=2048) while the absolute tolerance does not, the error's norm over the
#: output's norm: two right bfloat16 results differ by at most one rounding
#: of the output, 2^-8 of it, so 1e-2 leaves 2.5x; float32 keeps 2e-5
ATTN_REL_TOLERANCE = {"float32": 2e-5, "bfloat16": 1e-2}
ATTN_SHAPES = ((1, 1), (2, 7), (1, 128), (2, 130), (4, 1024), (1, 4096))
#: bfloat16 lengths whose last tile of 64 keys crosses the diagonal inside
#: it, at its edge or one key past it, at B=2
ATTN_DIAGONAL_S = (63, 64, 65, 127, 129, 191)
#: timed: the LM phase's two prefills; the plain version is timed only where
#: its scores fit (at S=32768 they would take 68.7 GB)
ATTN_TIMED = ((8, 2048, "bfloat16"), (8, 2048, "float32"), (1, 32768, "bfloat16"))
PLAIN_MAX_S = 4096
#: past PLAIN_MAX_S the kernel is checked on its first and last rows of
#: queries, each against all keys (scores (1, 16, 256, 32768): 0.54 GB)
ATTN_SLICE_ROWS = 256
#: the LM path: a prefill of 8 x 2048 then 32 greedy decode steps, and a
#: prefill of 1 x 32768 (LM_SHAPES' prefill_32k length; its batch of 32
#: would need 120 GB of KV cache, more than one 80 GB card)
LM_BATCH, LM_SEQ, LM_DECODE = 8, 2048, 32
LM_LONG = 32768
#: lm-check in float32: prefill flash vs chunked at this (B, S), and decode
#: at position S against forward over S+1 tokens
CHECK_B, CHECK_S = 2, 130
#: attn-bwd: the backward kernel against the plain backward at qwen3-0.6b's
#: H=16, Hkv=8, d=128: (B, S) from one token to 1 x 1024, and S around the
#: 64-key tiles at B=1. Tolerances: max abs error within atol + rtol |want|
#: and the error's norm over the gradient's. float32 differs only in the
#: order of float32 sums. bfloat16 rounds ds to bfloat16 for dq and dk as the
#: reference does, and P for dv where the reference keeps float32 (the
#: tensor cores take bf16): an output rounding (2^-8), ds values that round
#: to the other neighbour, and 2^-9 of each dv term, inside 1e-2 of the norm
BWD_SHAPES = ((1, 1), (2, 7), (1, 130), (2, 257), (1, 1024))
#: around the 64-key and 64-row tiles and the bfloat16 kernels' 128-key and
#: 128-row blocks
BWD_DIAGONAL_S = (63, 64, 65, 127, 128, 129, 191, 255, 256, 257)
BWD_TOLERANCE = {"float32": (1e-4, 1e-4, 2e-5), "bfloat16": (2e-2, 2e-2, 1e-2)}
#: the forward's lse against the plain lse (float32 sums in another order;
#: the bfloat16 route's exp2 and tensor-core sums)
LSE_TOLERANCE = {"float32": 2e-5, "bfloat16": 1e-4}
#: a gradient whose RMS is below this is rounding (at S=1 dq is 0)
RMS_FLOOR = 1e-3
#: timed, bfloat16: the training step's shape and the prefill's batch; the
#: float32 route (the checks' only) at the training step's shape
BWD_TIMED = ((4, 2048), (8, 2048))
BWD_TIMED_F32 = (4, 2048)
#: lm-train: float32 gradients through the kernels against "chunked" on
#: qwen3-0.6b at full width cut to this many layers, at (B, S); then the
#: full-width bfloat16 model trained through the launcher's build and
#: Trainer at (B, S) for this many steps; the CLI's run
TRAIN_CHECK_LAYERS, TRAIN_CHECK_B, TRAIN_CHECK_S = 2, 2, 130
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 2048, 20, 1e-3
TRAIN_CLI = ("--arch", "qwen3-0.6b", "--full", "--steps", "3", "--batch", "2",
             "--seq-len", "512", "--device", "cuda")
#: the float32 gradient check: each leaf's error norm over its gradient's,
#: and the loss's relative error
TRAIN_GRAD_REL = 1e-4
#: the EmbeddingBag kernel against its plain version: tests/test_kernels.py's
#: tolerances for it, its (V, d, B, L) shapes, and ragged bag counts (not a
#: multiple of a block's 8 bags)
BAG_TOLERANCE = {"float32": 1e-5, "bfloat16": 3e-2}
BAG_SHAPES = ((100, 16, 8, 4), (1000, 32, 16, 10), (64, 8, 4, 1), (1000, 128, 13, 3),
              (1000, 128, 1, 1))
#: the large multi-hot shape (B, L) at d=128
BAG_MULTI = (16384, 32)
#: float32 checks over a table of this many rows: 2.56e9 elements, past 2^31
BAG_F32_ROWS = 20_000_000
#: ids "from the last rows" lie in the last tenth of a table's rows
BAG_TOP = 0.1
#: serve_p99's timing cycles through this many id sets, 109 MB of rows in
#: all, more than the 50 MB L2 holds, so each launch finds its rows cold
BAG_P99_SETS = 32
#: the recsys path at RECSYS_SHAPES' serve and retrieval sizes: steps of each
REC_P99_STEPS, REC_BULK_STEPS, REC_RETRIEVAL_STEPS = 64, 3, 5
#: backends: the scorer buckets, timed calls a bucket, warm-up, batched and
#: local questions, timed batches, and the score gap under which two
#: neighbours may swap
BACKEND_BUCKETS = (1, 8, 64, 256)
BACKEND_CALLS = 50
BACKEND_WARM_Q, BACKEND_BATCH_Q, BACKEND_LOCAL_Q, BACKEND_ROUNDS = 8, 64, 32, 3
SWAP_ATOL = 2e-5

#: service: the paper's Table 2 (RPCs a backend from one client, warm-up
#: RPCs), its beyond-paper micro-batched row (client threads, RPCs each, the
#: engine's batching), and the unseen questions the remote plans rank
SERVICE_BACKENDS = ("pallas", "jit", "aot", "numpy")
SERVICE_RPCS, SERVICE_WARM = 300, 10
ENGINE_CLIENTS, ENGINE_MAX_BATCH, ENGINE_MAX_WAIT_S = 8, 64, 0.001
CONCURRENT_RPCS = 50   # a client thread's RPCs in each backend's concurrent check
SERVICE_PLAN_Q = 64
#: every wait of the service phase on a thread, a reply or a drain
SERVICE_WAIT_S = 60.0

#: launch: full-width training steps and batch; the ReplicaPools' backends
#: and replicas; client threads; rollout questions; fabric sizes and each
#: client thread's rank_batch RPCs of one question; every spawn and wait
LAUNCH_TRAIN_STEPS, LAUNCH_BATCH = 60, 64
POOL_BACKENDS, POOL_REPLICAS = ("pallas", "aot"), 2
LAUNCH_CLIENTS = 8
ROLLOUT_Q = 32
FABRIC_WORKERS, FABRIC_RPCS = (1, 4), 32
#: a worker's rank_batch of the whole world's questions goes in chunks of
#: this many (the launcher's admission bound takes 32 queries an RPC)
FABRIC_CHUNK = 16
LAUNCH_WAIT_S = 180.0
#: the launcher's world (reduced sm-cnn, S=16 d=8 F=12): its scorer buckets
#: but 8, which the kernel phase's small shape already is
LAUNCH_WORLD_SHAPES = ((1, 16, 8, 5, 12), (64, 16, 8, 5, 12), (256, 16, 8, 5, 12))

#: rec-check: serve batches and retrieval candidates
REC_CHECK_BATCHES, REC_CHECK_CANDIDATES = (512, 4096), 65536
#: bag-bwd: a field of this many rows named at this many positions (each
#: row ~21,845 times, as dlrm-mlperf's 3-row Criteo field at the training
#: batch); the float32 table past 2^31 elements is BAG_F32_ROWS rows
BAG_BWD_HOT = (3, 65536)
#: rec-train: each field cut to at most this many rows (the MLPerf DLRM
#: reference's --max-ind-range cap), steps and peak lr of Trainer + adamw,
#: the batch of the gradient-tree check, and the launcher's run on the card
REC_TRAIN_MAX_ROWS = 10 ** 6
REC_TRAIN_STEPS, REC_TRAIN_LR = 20, 1e-3
REC_TRAIN_CHECK_B = 512
REC_TRAIN_CLI = ("--arch", "dlrm-mlperf", "--steps", "3", "--device", "cuda")
#: rec-train and rec-family: the reduced float32 card-against-CPU checks,
#: the loss's relative error and each gradient element's tolerance (the CPU
#: tests' against JAX). Elementwise, not a norm over a leaf's norm: DIN's
#: last attention bias has a gradient that is 0 in exact arithmetic (the
#: softmax ignores a constant), so both sides hold rounding noise there
REC_LOSS_REL = 1e-5
REC_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
#: rec-family: FM and DIN at full width, serve_p99 steps timed, training steps
REC_FAMILY = ("fm", "din")
REC_FAMILY_P99_STEPS, REC_FAMILY_TRAIN_STEPS = 20, 5


class CheckFailed(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ device --

def phase_device(torch) -> dict:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {count} python {sys.version.split()[0]}")
    log("tf32: off for matmul and cuDNN (float32 compared in float32)")
    return {"card": card, "kind": kind, "count": count}


# ------------------------------------------------------------------- build --

def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # one nvcc per source, together
        list(pool.map(build.compile_library, KERNELS))
    for name in KERNELS:
        build.load_library(name)
    log(f"build: {', '.join(KERNELS)} ready in {time.perf_counter() - t0:.3f} s (sm_90a)")
    for name in KERNELS:
        log(f"build: {name} nvcc {build.BUILD_SECONDS[name]:.3f} s")
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if any(w in line for w in ("entry function", "registers", "spill", "arning",
                                       "Performance Loss")):
                log(f"  ptxas {name}: {line.strip()}")


# ------------------------------------------------------------------ kernel --

def _event_ms(torch, fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _time_alternating(torch, fns: dict, iters: int = 200, rounds: int = 3) -> dict:
    """Median over rounds of each function's mean time per call, the
    functions taking turns (a, b, c, c, b, a, ...) after a warm-up."""
    for fn in fns.values():
        for _ in range(10):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            times[name].append(_event_ms(torch, fns[name], iters))
    return {name: statistics.median(t) for name, t in times.items()}


def _queued_ms(torch, fn, iters: int) -> float:
    """ms a call of ``fn`` takes on the card with no host gaps between
    calls: a spin kernel holds the stream while the host queues ``iters``
    calls between two events. The time counts only if the first event had
    not been reached when the last call was queued, so the calls ran back
    to back; otherwise the spin doubles, and the phase fails past
    QUEUE_ATTEMPTS tries."""
    cycles = 1 << 24   # ~9 ms at the H100's 1.98 GHz
    for _ in range(QUEUE_ATTEMPTS):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 2
    check(False, f"the host queued {iters} calls slower than the card spun "
                 f"{cycles // 2} cycles, {QUEUE_ATTEMPTS} times")


def _profiled_split_ms(torch, fn, names, iters: int):
    """Device ms a call of ``fn`` spends in each kernel whose name holds one
    of ``names`` (each launched once a call), from torch.profiler over
    ``iters`` calls, or None. A session counts only if it recorded every
    launch, ``iters`` of each kernel: late in a long process the profiler
    loses kernel records (aten's too; `_busy_share` reports it), and a
    session that lost some would give too small a time. Up to
    PROFILE_ATTEMPTS sessions."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = {name: [] for name in names}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                for name in names:
                    if name in e.name:
                        times[name].append(e.time_range.elapsed_us())
        if all(len(t) == iters for t in times.values()):
            return {name: sum(t) / 1e3 / iters for name, t in times.items()}
    return None


def conv_bound(b: int, s: int, d: int, w: int, f: int, dtype: str):
    """Least time for the conv on the card: each input read once and the
    output written once at the memory rate, against the multiply-adds at
    the dtype's peak (the CUDA cores for float32, the tensor cores for
    bfloat16). Each of the S real rows meets each of the w taps once;
    products with the zero pad rows are not needed, so they are not counted.
    Also the float32-accurate bound on the tensor cores: 3xTF32, three TF32
    products for each float32 one (None for bfloat16)."""
    es = 4 if dtype == "float32" else 2
    n_bytes = (b * s * d + w * d * f + f + b * f) * es
    flops = 2 * b * s * w * d * f
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_3xtf32 = (max(t_bytes, 3 * flops / TF32_FLOPS * 1e3) if dtype == "float32"
                else None)
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), \
        n_bytes, flops, t_3xtf32


def phase_kernel(torch, cfg) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels import sm_cnn_conv as K

    s, d, w, f = cfg.max_len, cfg.embed_dim, cfg.filter_width, cfg.conv_filters
    gen = torch.Generator(device="cuda").manual_seed(1234)

    def inputs(b, s_, d_, w_, f_, dtype):
        dt = getattr(torch, dtype)
        x = torch.randn((b, s_, d_), generator=gen, device="cuda").to(dt)
        # pre-activations of std 0.3: tanh stays off its saturation, so the
        # outputs spread over (-1, 1) and the tolerances bite
        filt = (torch.randn((w_ * d_, f_), generator=gen, device="cuda")
                * (0.3 / math.sqrt(w_ * d_))).to(dt)
        bias = (torch.randn((f_,), generator=gen, device="cuda") * 0.1).to(dt)
        return x, filt, bias

    routes = {}
    for dtype in ("float32", "bfloat16"):
        info = routes[dtype] = K.route_info(getattr(torch, dtype), s, d, f)
        log(f"kernel: {dtype} route: stage {info['stage']} ({info['design']}), "
            f"registers={info['registers']} spill_bytes={info['local_bytes']} "
            f"static_smem={info['static_smem']} dynamic_smem={info['dynamic_smem']} "
            f"blocks_per_sm={info['blocks_per_sm']} threads={info['threads']} "
            f"at S={s} d={d} F={f}")
        check(info["local_bytes"] == 0, f"the {dtype} conv kernel spills")

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    shapes = ([(b, s, d, w, f) for b in KERNEL_BATCHES] + [(8, 16, 8, 5, 12)]
              + list(LAUNCH_WORLD_SHAPES) + list(KERNEL_EDGE_SHAPES))
    for shape in shapes:
        for dtype in ("float32", "bfloat16"):
            x, filt, bias = inputs(*shape, dtype)
            got = K.conv_tanh_maxpool(x, filt, bias, shape[3])
            want = K.conv_tanh_maxpool_plain(x, filt, bias, shape[3])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ok = math.isfinite(err) and err <= TOLERANCE[dtype]
            log(f"kernel: B={shape[0]} S={shape[1]} d={shape[2]} w={shape[3]} "
                f"F={shape[4]} {dtype}: max_abs_err={err:.3e} "
                f"tol={TOLERANCE[dtype]} {'ok' if ok else 'FAIL'}")
            check(ok, f"conv kernel disagrees with its plain version at "
                      f"{shape} {dtype}: {err}")
            if shape[1:] == (s, d, w, f):
                max_err[dtype] = max(max_err[dtype], err)

    # NaN and +-inf, as tests/test_torch_kernels.py places them: a NaN in
    # sample 0, +inf and -inf at sample 1's first and last rows, a NaN in
    # the last filter column. JAX's max keeps NaN and tanh(+-inf) is +-1.
    for dtype in ("float32", "bfloat16"):
        x, filt, bias = inputs(256, s, d, w, f, dtype)
        x[0, s // 2, 1] = math.nan
        x[1, 0, 2] = math.inf
        x[1, s - 1, 0] = -math.inf
        filt[3, f - 1] = math.nan
        got = K.conv_tanh_maxpool(x, filt, bias, w).float()
        want = K.conv_tanh_maxpool_plain(x, filt, bias, w).float()
        torch.cuda.synchronize()
        same_nan = bool(torch.equal(got.isnan(), want.isnan()))
        finite = ~want.isnan()
        err = (got[finite] - want[finite]).abs().max().item()
        shape_ok = (bool(got[0].isnan().all()) and bool(got[:, -1].isnan().all())
                    and bool(torch.isfinite(got[1:, :-1]).all())
                    and bool((got[1, :-1] == 1.0).any()))
        ok = same_nan and shape_ok and err <= TOLERANCE[dtype]
        log(f"kernel: non-finite inputs B=256 {dtype}: NaN positions "
            f"{'equal' if same_nan else 'DIFFER'} ({int(got.isnan().sum())} NaN), "
            f"sample 0 and filter {f - 1} NaN, +-inf giving +1: {shape_ok}; "
            f"finite max_abs_err={err:.3e} tol={TOLERANCE[dtype]} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"conv kernel on non-finite inputs {dtype}: NaN positions equal "
                  f"{same_nan}, pattern {shape_ok}, finite error {err}")

    timings = {}
    for b in TIMED_BATCHES:
        for dtype in ("float32", "bfloat16"):
            x, filt, bias = inputs(b, s, d, w, f, dtype)
            # the library yardstick's layouts are made once, outside the timing
            x_t = x.transpose(1, 2).contiguous()                      # (B, d, S)
            w_t = filt.view(w, d, f).permute(2, 1, 0).contiguous()    # (F, d, w)

            def library():
                return torch.amax(torch.tanh(F.conv1d(x_t, w_t, bias, padding=w - 1)), -1)

            lib_err = (library().float()
                       - K.conv_tanh_maxpool_plain(x, filt, bias, w).float()
                       ).abs().max().item()
            t = _time_alternating(torch, {
                "kernel": lambda: K.conv_tanh_maxpool(x, filt, bias, w),
                "plain": lambda: K.conv_tanh_maxpool_plain(x, filt, bias, w),
                "library": library,
            })
            dev_ms = _queued_ms(torch, lambda: K.conv_tanh_maxpool(x, filt, bias, w), 20)
            bound_ms, bound_by, n_bytes, flops, tf32_ms = conv_bound(b, s, d, w, f, dtype)
            timings[(b, dtype)] = dict(t, bound_ms=bound_ms, bound_by=bound_by,
                                       device_ms=dev_ms, bound_ms_3xtf32=tf32_ms)
            tf32_note = ("" if tf32_ms is None else
                         f" bound_ms_3xtf32={tf32_ms:.5f} (3 x {flops / 1e9:.3f} GFLOP "
                         f"at 495 TFLOP/s) share_of_3xtf32_bound="
                         f"{tf32_ms / t['kernel']:.3f}")
            log(f"kernel: B={b} {dtype} kernel_ms={t['kernel']:.5f} "
                f"kernel_device_ms={dev_ms:.5f} "
                f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} "
                f"(F.conv1d+tanh+amax, max_abs_err vs plain {lib_err:.2e}) "
                f"bound_ms={bound_ms:.5f} ({bound_by}: {flops / 1e9:.3f} GFLOP "
                f"at {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, {n_bytes / 1e6:.3f} MB "
                f"at 3.35 TB/s) share_of_bound={bound_ms / t['kernel']:.3f}"
                f"{tf32_note} achieved_tflops={flops / t['kernel'] / 1e9:.1f}")
    return {"max_err": max_err, "timings": timings, "routes": routes}


# ---------------------------------------------------------------- pipeline --

def _percentile(values, q):
    vals = sorted(values)
    pos = (len(vals) - 1) * q
    lo, hi = math.floor(pos), math.ceil(pos)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def _busy_share(torch, run, kernel: str = "conv_tanh_maxpool", top: int = 5) -> str:
    """Device busy time (union of kernel intervals) over the host wall time
    of one call of ``run``, from torch.profiler, with the time and launches
    of the kernels whose name holds ``kernel`` and the ``top`` kernel names
    that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, kernel_ms, kernel_n, by_name = [], 0.0, 0, {}
    # kernel launches on the host against kernel records on the device (a
    # graph launch runs several): fewer records means the profiler lost some
    launched = recorded = 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            launched += e.name in LAUNCH_CALLS
            continue
        recorded += not e.name.startswith(("Memcpy", "Memset"))
        spans.append((e.time_range.start, e.time_range.end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        if kernel in e.name:
            kernel_ms += e.time_range.elapsed_us() / 1e3
            kernel_n += 1
    if not spans:
        return f"busy share not measured (the profiler saw no device events in {wall_ms:.3f} ms)"
    busy, cur_s, cur_e = 0.0, None, None
    for s_, e_ in sorted(spans):
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy = (busy + cur_e - cur_s) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    lost = (f"; the profiler LOST records: {recorded} kernel records for {launched} "
            f"launches, so busy is a lower bound" if recorded < launched else
            f"; {recorded} kernel records for {launched} launches")
    return (f"device busy {busy:.3f} ms over {len(spans)} device events "
            f"({kernel} {kernel_ms:.3f} ms, {kernel_n} launches, "
            f"{kernel_ms / busy:.4f} of the device time) in a "
            f"{wall_ms:.3f} ms profiled run: busy share {busy / wall_ms:.4f} "
            f"(idle {1 - busy / wall_ms:.4f}){lost}; top device time: "
            + "; ".join(f"{name[:72]} {ms:.3f} ms x{n}" for name, (ms, n) in ranked))


def phase_pipeline(torch, cfg, seed: int, n_docs: int = 2000, n_questions: int = 256,
                   n_local: int = 32, batches: int = 3) -> dict:
    from repro_torch.core import backends, bm25, ops
    from repro_torch.core.plan import PlanContext, plan, verify_plans
    from repro_torch.data import qa
    from repro_torch.data.tokenizer import HashingTokenizer
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.models import sm_cnn
    from repro_torch.serving import telemetry

    t0 = time.perf_counter()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=seed)
    corpus = qa.generate_corpus(n_docs=n_docs, n_questions=n_questions, seed=0)
    tok = HashingTokenizer(cfg.vocab_size)
    index = bm25.build_index([tok.encode(" ".join(doc)) for doc in corpus.documents],
                             cfg.vocab_size)
    ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
    sync = torch.cuda.synchronize
    pipe = ops.Retrieve(h=20) >> ops.Rerank("pallas") % 10
    local, batched = plan(pipe, "local", ctx), plan(pipe, "batched", ctx)
    queries = corpus.questions
    n_params = cfg.n_params()
    log(f"pipeline: cfg={cfg.name} vocab={cfg.vocab_size} d={cfg.embed_dim} "
        f"F={cfg.conv_filters} w={cfg.filter_width} max_len={cfg.max_len} "
        f"hidden={cfg.n_hidden} params={n_params} {cfg.dtype}; corpus {n_docs} docs, "
        f"{len(queries)} questions; setup {time.perf_counter() - t0:.3f} s")
    log(f"pipeline: {pipe!r}")
    for p in (local, batched):
        log(f"pipeline: {p.describe()}")
    # warm-up: first launches, allocator, cuBLAS handles
    local.run_many(queries[:2])
    batched.run_many(queries[:8])
    sync()

    # ---- the main path, counted ----
    K.reset_launches()
    for s_ in ctx.scorers():
        s_.calls = 0
    telemetry.reset_all()
    lat = []
    for q in queries[:n_local]:
        t = time.perf_counter()
        local.run(q)
        sync()
        lat.append(time.perf_counter() - t)
    spans = {"local": telemetry.stage_breakdown(telemetry.get_tracer().finished())}
    telemetry.get_tracer().clear()
    batch_s = []
    results = None
    for _ in range(batches):
        t = time.perf_counter()
        results = batched.run_many(queries)
        sync()
        batch_s.append(time.perf_counter() - t)
    launches = K.launches
    pallas_calls = sum(s_.calls for s_ in ctx.scorers() if s_.name == "pallas")
    spans["batched"] = telemetry.stage_breakdown(telemetry.get_tracer().finished())
    # ---- end of the counted run ----

    log(f"pipeline: local {n_local} queries in {sum(lat):.4f} s: "
        f"q/s={n_local / sum(lat):.3f} p50_ms={_percentile(lat, 0.5) * 1e3:.3f} "
        f"p99_ms={_percentile(lat, 0.99) * 1e3:.3f}")
    med = statistics.median(batch_s)
    log(f"pipeline: batched {len(queries)} queries per batch, {batches} batches: "
        f"batch_s={','.join(f'{b:.4f}' for b in batch_s)} q/s={len(queries) / med:.3f} "
        f"p50_ms={_percentile(batch_s, 0.5) * 1e3:.3f} "
        f"p99_ms={_percentile(batch_s, 0.99) * 1e3:.3f} (every query of a batch "
        f"waits for the whole batch)")
    for target, rows in spans.items():
        for name, row in sorted(rows.items()):
            log(f"pipeline: {target} span {name}: count={int(row['count'])} "
                f"total_ms={row['total_ms']:.3f} mean_ms={row['mean_ms']:.4f}")
    log(f"pipeline: conv_tanh_maxpool launches={launches} over {pallas_calls} "
        f"pallas scorer calls")
    check(launches > 0, "the main path launched the conv kernel no time")
    check(launches == 2 * pallas_calls,
          f"expected 2 conv launches per pallas scorer call, got {launches} "
          f"for {pallas_calls} calls")

    # ---- what came out ----
    check(len(results) == len(queries), "batched plan lost queries")
    n_ranked = 0
    for cands, _ in results:
        check(len(cands) <= 10, "more than k=10 candidates")
        for c in cands:
            check(math.isfinite(c.score) and 0.0 <= c.score <= 1.0,
                  f"score {c.score} is not a probability")
        check([c.score for c in cands] == sorted((c.score for c in cands), reverse=True),
              "ranking is not sorted by score")
        n_ranked += bool(cands)
    check(n_ranked > len(queries) // 2, f"only {n_ranked} queries got candidates")
    log(f"pipeline: {n_ranked}/{len(queries)} queries ranked, scores finite "
        f"probabilities in descending order")
    log(f"pipeline: batched {_busy_share(torch, lambda: batched.run_many(queries))}")

    verify_plans([local, batched], queries[:n_local], tie_atol=TIE_ATOL)
    log(f"pipeline: local == batched on {n_local} queries (verify_plans, "
        f"tie_atol={TIE_ATOL})")
    eager = plan(ops.Retrieve(h=20) >> ops.Rerank("eager") % 10, "batched", ctx)
    verify_plans([batched, eager], queries, tie_atol=TIE_ATOL)
    log(f"pipeline: pallas rankings == eager rankings on {len(queries)} queries "
        f"(swaps only within tie_atol={TIE_ATOL})")

    # the card's scorer against the CPU's plain model on the same rows
    rows = qa.make_batch(corpus, tok, cfg.max_len, corpus.pairs[:8])
    on_card = backends.make_scorer("pallas", tree, cfg, buckets=(8,), device="cuda")
    on_cpu = backends.make_scorer("eager", tree, cfg, buckets=(8,), device="cpu")
    a = on_card(rows["q_tok"], rows["a_tok"], rows["feats"])
    b = on_cpu(rows["q_tok"], rows["a_tok"], rows["feats"])
    err = float(abs(a - b).max())
    check(bool(((abs(a - b)) <= 1e-5 + 1e-4 * abs(b)).all()),
          f"pallas on the card disagrees with eager on the CPU: {err}")
    log(f"pipeline: pallas on the card == eager on the CPU on 8 rows "
        f"(max_abs_err={err:.3e}, rtol=1e-4 atol=1e-5)")
    return {"launches": launches, "world": (tree, corpus, tok, index)}


# ---------------------------------------------------------------- backends --

def _swaps(want, got, what: str) -> int:
    """The neighbour swaps between two top-k lists of one query; any other
    difference, or a swap of scores ``SWAP_ATOL`` or more apart in ``want``,
    fails. A last place that differs counts as a swap with the candidate
    past the cut when the two scores are that close."""
    ids = [(c.doc_id, c.sent_id) for c in want]
    gids = [(c.doc_id, c.sent_id) for c in got]
    check(len(ids) == len(gids), f"{what}: {len(gids)} candidates, eager {len(ids)}")
    swaps, i = 0, 0
    while i < len(ids):
        if ids[i] == gids[i]:
            i += 1
            continue
        if i + 1 < len(ids):
            check(ids[i] == gids[i + 1] and ids[i + 1] == gids[i]
                  and abs(want[i].score - want[i + 1].score) < SWAP_ATOL,
                  f"{what}: rank {i} differs from eager's beyond a swap of near-ties "
                  f"({gids[i]} for {ids[i]})")
            i += 2
        else:
            check(abs(want[i].score - got[i].score) < SWAP_ATOL,
                  f"{what}: last place differs from eager's ({gids[i]} for {ids[i]})")
            i += 1
        swaps += 1
    return swaps


def phase_backends(torch, cfg, world) -> dict:
    import numpy as np
    from torch._dynamo.utils import counters

    from repro_torch.core import backends, ops
    from repro_torch.core.plan import PlanContext, plan
    from repro_torch.data import qa
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving import telemetry

    tree, corpus, tok, index = world
    buckets = BACKEND_BUCKETS
    rows = qa.make_batch(corpus, tok, cfg.max_len, corpus.pairs[:buckets[-1]])
    q, a, f = rows["q_tok"], rows["a_tok"], rows["feats"]
    eager = backends.make_scorer("eager", tree, cfg, buckets, device="cuda")
    want = {b: eager(q[:b], a[:b], f[:b]) for b in buckets}
    log(f"backends: sm-cnn full width, buckets {buckets}, {BACKEND_CALLS} timed calls "
        f"a bucket (host clock around each Scorer call, which ends in the copy of "
        f"the scores to the host)")
    table = {}
    for name in backends.BACKENDS:
        t0 = time.perf_counter()
        scorer = backends.make_scorer(name, tree, cfg, buckets, device="cuda")
        table[name] = {"scorer": scorer}
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        stats = scorer.programs
        errs = {}
        for b in buckets:   # first calls: jit compiles here
            got = scorer(q[:b], a[:b], f[:b])
            errs[b] = float(abs(got - want[b]).max())
            check(bool((abs(got - want[b]) <= 1e-5 + 1e-4 * abs(want[b])).all()),
                  f"backends: {name} bucket {b} disagrees with eager: {errs[b]:.3e}")
        compiles = stats.compiles if stats else 0
        if name == "jit":
            check(compiles == len(buckets),
                  f"backends: jit compiled {compiles} programs for {len(buckets)} buckets")
        if name == "aot":
            check(compiles == len(buckets) and stats.replays == len(buckets),
                  f"backends: aot compiled {compiles} programs and replayed "
                  f"{stats.replays} graphs for {len(buckets)} buckets and calls")
            check(stats.inputs == [3] * len(buckets),
                  f"backends: aot's programs take {stats.inputs} inputs, not the 3 rows "
                  f"alone: the weights were not frozen into constants")
        if name == "jit":
            check(all(n > 3 for n in stats.inputs),
                  f"backends: jit's programs take {stats.inputs} inputs: the weights "
                  f"are not arguments")

        # ---- timed calls, counted ----
        graphs = counters["stats"]["unique_graphs"]
        replays = stats.replays if stats else 0
        K.reset_launches()
        calls0 = scorer.calls
        per_bucket = {}
        for b in buckets:
            lat = []
            for _ in range(BACKEND_CALLS):
                t = time.perf_counter()
                scorer(q[:b], a[:b], f[:b])
                lat.append(time.perf_counter() - t)
            per_bucket[b] = lat
        launches, calls = K.launches, scorer.calls - calls0
        # ---- end of the counted calls ----
        check(launches == (2 * calls if name == "pallas" else 0),
              f"backends: {name} launched the conv kernel {launches} times in {calls} calls")
        check(counters["stats"]["unique_graphs"] == graphs
              and (stats.compiles if stats else 0) == compiles,
              f"backends: {name} compiled during the timed calls")
        if name == "aot":
            check(stats.replays - replays == calls,
                  f"backends: aot replayed {stats.replays - replays} graphs in {calls} calls")
        log(f"backends: {name} build_s={build_s:.3f} compiled={compiles} "
            f"conv_launches={launches} in {calls} calls"
            + (f" graph_replays={stats.replays - replays}" if name == "aot" else "")
            + (f" program_inputs={stats.inputs}" if stats else "")
            + f" max_abs_err_vs_eager={max(errs.values()):.3e}")
        table[name].update(build_s=build_s, buckets={})
        for b, lat in per_bucket.items():
            p50, p99 = _percentile(lat, 0.5) * 1e3, _percentile(lat, 0.99) * 1e3
            table[name]["buckets"][b] = (p50, p99)
            log(f"backends: {name} bucket {b}: p50_ms={p50:.4f} p99_ms={p99:.4f} "
                f"rows/s={b / (p50 / 1e3):.1f}")

    # ---- the ranking pipeline on each backend ----
    # Each backend ranks in a context of its own: its own featurization
    # cache and scorers. Every bucket of its scorers is built on rows of
    # zeros, and the plans warm up on questions that no timed run takes.
    # Each timed batch then takes questions the context has not seen, as
    # ranking traffic does, and the backends take turns batch by batch, so
    # that the host's drift falls on all of them alike.
    queries = corpus.questions
    start = BACKEND_WARM_Q + BACKEND_ROUNDS * BACKEND_BATCH_Q
    timed = [queries[BACKEND_WARM_Q + r * BACKEND_BATCH_Q:][:BACKEND_BATCH_Q]
             for r in range(BACKEND_ROUNDS)]
    local_q = queries[start:start + BACKEND_LOCAL_Q]
    check(len(local_q) == BACKEND_LOCAL_Q,
          f"backends: {len(queries)} questions are too few for the timed runs")
    names = ("eager",) + tuple(n for n in backends.BACKENDS if n != "eager")
    runs = {}
    for name in names:
        ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
        pipe = ops.Retrieve(h=20) >> ops.Rerank(name) % 10
        t0 = time.perf_counter()
        local, batched = plan(pipe, "local", ctx), plan(pipe, "batched", ctx)
        mine = [s_ for s_ in ctx.scorers() if s_.name == name]
        for s_ in mine:
            for b in s_._buckets:
                s_(np.zeros((b, cfg.max_len), np.int32), np.zeros((b, cfg.max_len), np.int32),
                   np.zeros((b, cfg.n_extra_feats), np.float32))
        local.run_many(queries[:BACKEND_WARM_Q])
        batched.run_many(queries[:BACKEND_WARM_Q])
        torch.cuda.synchronize()
        compiles = [s_.programs.compiles if s_.programs else 0 for s_ in mine]
        if name in ("jit", "aot"):
            for s_, c in zip(mine, compiles):
                check(c == len(s_._buckets),
                      f"backends: {name} compiled {c} programs for ladder {s_._buckets}")
        runs[name] = {"local": local, "batched": batched, "mine": mine,
                      "compiles": compiles, "warm_s": time.perf_counter() - t0,
                      "batch_s": [], "feat": [], "lat": []}

    # ---- timed, in turns; a last batch runs the last one's questions
    # again, so that its featurization comes from the context's cache ----
    graphs = counters["stats"]["unique_graphs"]
    tracer = telemetry.get_tracer()
    results = {}
    for r, qs in enumerate(timed + timed[-1:]):
        for name in names:
            run = runs[name]
            tracer.clear()
            t = time.perf_counter()
            res = run["batched"].run_many(qs)
            torch.cuda.synchronize()
            run["batch_s"].append(time.perf_counter() - t)
            feats = [sp for sp in tracer.finished() if sp.name == "featurize"]
            run["feat"].append((sum(sp.dur_us for sp in feats) / 1e3,
                                sum(int(sp.attrs.get("hits", 0)) for sp in feats),
                                sum(int(sp.attrs.get("misses", 0)) for sp in feats)))
            if r == 0:
                results[name] = res
    tracer.clear()
    for qq in local_q:
        for name in names:
            t = time.perf_counter()
            runs[name]["local"].run(qq)
            torch.cuda.synchronize()
            runs[name]["lat"].append(time.perf_counter() - t)
    # ---- end of the timed runs ----
    check(counters["stats"]["unique_graphs"] == graphs,
          "backends: a pipeline compiled a graph while timed")

    for name in names:
        run, mine = runs[name], runs[name]["mine"]
        check([s_.programs.compiles if s_.programs else 0 for s_ in mine] == run["compiles"],
              f"backends: the {name} pipeline compiled while timed")
        swaps = sum(_swaps(w, g, f"backends: {name} query {i}")
                    for i, ((w, _), (g, _)) in enumerate(zip(results["eager"], results[name])))
        batch_s, feat, lat = run["batch_s"][:-1], run["feat"][:-1], run["lat"]
        med = statistics.median(batch_s)
        busy = _busy_share(torch, lambda: run["batched"].run_many(timed[0]))
        log(f"backends: {name} pipeline batched, profiled on the first batch's "
            f"questions: {busy}")
        log(f"backends: {name} pipeline ladders={[s_._buckets for s_ in mine]} "
            f"compiled={run['compiles']} "
            f"inputs={[s_.programs.inputs for s_ in mine if s_.programs]} "
            f"warm-up {run['warm_s']:.3f} s; batched {BACKEND_BATCH_Q} unseen q "
            f"batch_s={','.join(f'{b_:.4f}' for b_ in batch_s)} q/s={BACKEND_BATCH_Q / med:.3f} "
            f"featurize_ms={','.join(f'{f_[0]:.3f}' for f_ in feat)} "
            f"cache hits={','.join(str(f_[1]) for f_ in feat)} "
            f"misses={','.join(str(f_[2]) for f_ in feat)}; the last batch's questions "
            f"again: batch_s={run['batch_s'][-1]:.4f} featurize_ms={run['feat'][-1][0]:.3f} "
            f"hits={run['feat'][-1][1]} misses={run['feat'][-1][2]}; "
            f"local {BACKEND_LOCAL_Q} unseen q p50_ms={_percentile(lat, 0.5) * 1e3:.3f} "
            f"p99_ms={_percentile(lat, 0.99) * 1e3:.3f}; "
            f"top-10 == eager's with {swaps} near-tie swaps")
        table[name]["pipeline"] = {"qps": BACKEND_BATCH_Q / med, "swaps": swaps,
                                   "p50_ms": _percentile(lat, 0.5) * 1e3,
                                   "p99_ms": _percentile(lat, 0.99) * 1e3}
    return table


# ----------------------------------------------------------------- service --

def _rpc_table_row(torch, scorer, handler, reqs, K, SV, telemetry) -> dict:
    """One Table 2 row: ``SERVICE_RPCS`` get_score RPCs from one client to a
    SimpleServer over ``handler``, each timed on the host clock; the conv's
    launch counter and the scorer's call count read around them, and the
    p50 of the server's request spans (``server.score``: decode to reply
    encoded) and of the scorer's spans inside them. The same pairs then go
    through the handler in process, one a call: back to back on this thread,
    and on a second thread that a queue wakes for each call and that hands
    each score back through another, as the server's thread is woken by
    each request (the socket, codec and spans left out)."""
    tracer = telemetry.get_tracer()
    with SV.SimpleServer(handler).start_background() as srv, SV.Client(srv.address) as cl:
        for q, a in reqs[:SERVICE_WARM]:
            cl.get_score(q, a)
        torch.cuda.synchronize()
        tracer.clear()
        # ---- the service path, counted ----
        K.reset_launches()
        calls0 = scorer.calls
        lat, got = [], []
        t0 = time.perf_counter()
        for q, a in reqs:
            t = time.perf_counter()
            got.append(cl.get_score(q, a))
            lat.append(time.perf_counter() - t)
        wall = time.perf_counter() - t0
        launches, calls = K.launches, scorer.calls - calls0
        # ---- end of the counted RPCs ----
    spans = {}
    for sp in tracer.finished():
        spans.setdefault(sp.name, []).append(sp.dur_us / 1e3)
    tracer.clear()
    local_lat, want = [], []
    for q, a in reqs:
        t = time.perf_counter()
        want.append(float(handler.get_scores([(q, a)])[0]))
        local_lat.append(time.perf_counter() - t)
    inbox, outbox = queue.Queue(), queue.Queue()

    def serve():
        for pair in iter(inbox.get, None):
            outbox.put(float(handler.get_scores([pair])[0]))

    worker = threading.Thread(target=serve, daemon=True)
    worker.start()
    woken_lat = []
    try:
        for q, a in reqs:
            t = time.perf_counter()
            inbox.put((q, a))
            outbox.get(timeout=SERVICE_WAIT_S)
            woken_lat.append(time.perf_counter() - t)
    finally:
        inbox.put(None)
        worker.join(timeout=SERVICE_WAIT_S)
    check(not worker.is_alive(), "service: the woken handler thread did not stop")
    return {"lat": lat, "wall": wall, "got": got, "want": want, "launches": launches,
            "calls": calls, "local_lat": local_lat, "woken_lat": woken_lat,
            "server_p50_ms": _percentile(spans.get("server.score", [0.0]), 0.5),
            "scorer_span_p50_ms": _percentile(spans.get("scorer", [0.0]), 0.5)}


def _concurrent_rows(scorer, handler, pairs, name, K, SV) -> dict:
    """``ENGINE_CLIENTS`` client threads at once, each sending its own share
    of ``pairs`` one ``get_score`` at a time, to a ThreadPoolServer of as
    many workers over ``handler``; every reply is held against its pair's
    score from the handler in process, one pair a call. Returns q/s, p50
    and p99 ms, the conv's launches and the scorer's calls."""
    import numpy as np

    results, lat = {}, {}
    with SV.ThreadPoolServer(handler, num_workers=ENGINE_CLIENTS).start_background() as srv:
        def client(c: int) -> None:
            out, ls = [], []
            with SV.Client(srv.address) as cl:
                for q, a in pairs[c::ENGINE_CLIENTS]:
                    t = time.perf_counter()
                    out.append(cl.get_score(q, a))
                    ls.append(time.perf_counter() - t)
            results[c], lat[c] = out, ls

        threads = [threading.Thread(target=client, args=(c,)) for c in range(ENGINE_CLIENTS)]
        K.reset_launches()
        calls0 = scorer.calls
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVICE_WAIT_S)
        wall = time.perf_counter() - t0
        launches, calls = K.launches, scorer.calls - calls0
    check(not any(t.is_alive() for t in threads) and len(results) == ENGINE_CLIENTS,
          f"service: a concurrent {name} client did not finish")
    want = [float(handler.get_scores([p])[0]) for p in pairs]
    err = 0.0
    for c, got in results.items():
        got, ref = np.asarray(got), np.asarray(want[c::ENGINE_CLIENTS])
        err = max(err, float(abs(got - ref).max()))
        check(len(got) == len(ref) and bool((abs(got - ref) <= 1e-5 + 1e-4 * abs(ref)).all()),
              f"service: {name} behind a ThreadPoolServer answered client {c} with "
              f"scores not its own pairs' (max error {err:.3e})")
    check(calls == len(pairs) and launches == (2 * calls if name == "pallas" else 0),
          f"service: {len(pairs)} concurrent {name} RPCs made {calls} scorer calls and "
          f"{launches} conv launches")
    all_lat = [x for v in lat.values() for x in v]
    p50, p99 = _percentile(all_lat, 0.5) * 1e3, _percentile(all_lat, 0.99) * 1e3
    log(f"service: concurrent {name}: ThreadPoolServer {ENGINE_CLIENTS} workers, "
        f"{ENGINE_CLIENTS} client threads x {len(pairs) // ENGINE_CLIENTS} RPCs of pairs "
        f"of their own: q/s={len(pairs) / wall:.3f} p50_ms={p50:.4f} p99_ms={p99:.4f}; "
        f"every reply its own pair's score (max_abs_err_vs_in_process={err:.3e}); "
        f"conv_launches={launches} in {calls} scorer calls")
    return {"qps": len(pairs) / wall, "p50_ms": p50, "p99_ms": p99, "launches": launches}


def phase_service(torch, cfg, world, scorers: dict) -> dict:
    """The paper's first integration strategy, the Thrift-style service
    (its Table 2), on the card; ``scorers`` are the backends phase's, with
    their bucket-1 p50."""
    import numpy as np

    from repro_torch.core import ops, wire
    from repro_torch.core import service as SV
    from repro_torch.core.plan import PlanContext, plan, verify_plans
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving.admission import AdmissionController
    from repro_torch.serving import telemetry
    from repro_torch.serving.engine import PipelineEngine, ServingEngine

    tree, corpus, tok, index = world
    reqs = [(corpus.questions[qi], corpus.documents[di][si])
            for qi, di, si, _ in corpus.pairs[:SERVICE_RPCS]]
    check(len(reqs) == SERVICE_RPCS, f"service: {len(reqs)} pairs, fewer than {SERVICE_RPCS}")
    log(f"service: Table 2: {SERVICE_RPCS} get_score RPCs a backend from one client "
        f"thread to a SimpleServer over a QuestionAnsweringHandler (tokenize + overlap "
        f"features + the backends phase's scorer) on 127.0.0.1, host clock around each "
        f"RPC; overhead = RPC p50 - the same handler's p50 in process, back to back, in "
        f"this run (the codec, loopback and wake-ups); overhead_vs_b1 = RPC p50 - that "
        f"scorer's bucket-1 p50 in the backends phase")
    live = sorted(t.name for t in threading.enumerate())
    log(f"service: {len(live)} threads live in the process before serving: {', '.join(live)}")

    class NullHandler:
        """The service stack alone: no featurization, no scorer."""
        calls = 0

        def get_scores(self, pairs):
            self.calls += 1
            return np.zeros(len(pairs))

    null = NullHandler()
    r = _rpc_table_row(torch, null, null, reqs, K, SV, telemetry)
    check(r["launches"] == 0 and r["calls"] == SERVICE_RPCS and not any(r["got"]),
          "service: the null handler's RPCs went wrong")
    p50, p99 = _percentile(r["lat"], 0.5) * 1e3, _percentile(r["lat"], 0.99) * 1e3
    log(f"service: table2 null handler (codec, socket, server dispatch and spans; no "
        f"featurization, no scorer): q/s={SERVICE_RPCS / r['wall']:.3f} p50_ms={p50:.4f} "
        f"p99_ms={p99:.4f} server_span_p50_ms={r['server_p50_ms']:.4f}")
    rows = {"null": {"qps": SERVICE_RPCS / r["wall"], "p50_ms": p50, "p99_ms": p99}}
    for name in SERVICE_BACKENDS:
        scorer = scorers[name]["scorer"]
        compiles = scorer.programs.compiles if scorer.programs else 0
        handler = SV.QuestionAnsweringHandler(scorer, tok, corpus.idf, cfg.max_len)
        r = _rpc_table_row(torch, scorer, handler, reqs, K, SV, telemetry)
        got, want = np.asarray(r["got"]), np.asarray(r["want"])
        err = float(abs(got - want).max())
        check(bool((abs(got - want) <= 1e-5 + 1e-4 * abs(want)).all()),
              f"service: {name} RPC scores disagree with the scorer in process: {err:.3e}")
        check(r["calls"] == SERVICE_RPCS,
              f"service: {name} scorer called {r['calls']} times for {SERVICE_RPCS} RPCs")
        check(r["launches"] == (2 * SERVICE_RPCS if name == "pallas" else 0),
              f"service: {name} launched the conv kernel {r['launches']} times in "
              f"{SERVICE_RPCS} RPCs")
        check((scorer.programs.compiles if scorer.programs else 0) == compiles,
              f"service: {name} compiled while serving")
        p50, p99 = _percentile(r["lat"], 0.5) * 1e3, _percentile(r["lat"], 0.99) * 1e3
        h50 = _percentile(r["local_lat"], 0.5) * 1e3
        w50 = _percentile(r["woken_lat"], 0.5) * 1e3
        s50 = scorers[name]["buckets"][1][0]
        rows[name] = {"qps": SERVICE_RPCS / r["wall"], "p50_ms": p50, "p99_ms": p99,
                      "scorer_p50_ms": s50, "overhead_ms": p50 - h50,
                      "overhead_vs_b1_ms": p50 - s50, "handler_p50_ms": h50,
                      "woken_p50_ms": w50,
                      "launches": r["launches"], "server_p50_ms": r["server_p50_ms"],
                      "scorer_span_p50_ms": r["scorer_span_p50_ms"]}
        log(f"service: table2 {name}: q/s={SERVICE_RPCS / r['wall']:.3f} p50_ms={p50:.4f} "
            f"p99_ms={p99:.4f} overhead_p50_ms={p50 - h50:.4f} over the handler in "
            f"process (p50_ms={h50:.4f} back to back: featurize + scorer; {w50:.4f} on a "
            f"woken thread); overhead_vs_b1_ms={p50 - s50:.4f} over scorer_b1_p50_ms="
            f"{s50:.4f}; server span p50_ms={r['server_p50_ms']:.4f}, the "
            f"scorer's span in it {r['scorer_span_p50_ms']:.4f}) "
            f"conv_launches={r['launches']} in {r['calls']} "
            f"scorer calls; max_abs_err_vs_in_process={err:.3e}")

    engine_reqs = [(corpus.questions[qi], corpus.documents[di][si])
                   for qi, di, si, _ in corpus.pairs[:ENGINE_CLIENTS * SERVICE_RPCS]]
    check(len(engine_reqs) == ENGINE_CLIENTS * SERVICE_RPCS,
          f"service: {len(engine_reqs)} pairs for the concurrent clients")

    # ---- every backend behind a ThreadPoolServer under concurrent clients:
    # one scorer called from many threads at once answers each its own pair ----
    for name in SERVICE_BACKENDS:
        rows[name]["concurrent"] = _concurrent_rows(
            scorers[name]["scorer"], SV.QuestionAnsweringHandler(
                scorers[name]["scorer"], tok, corpus.idf, cfg.max_len),
            engine_reqs[:ENGINE_CLIENTS * CONCURRENT_RPCS], name, K, SV)

    # ---- beyond the paper: the micro-batching engine under concurrent clients,
    # each sending pairs of its own, every pair once ----
    scorer = scorers["pallas"]["scorer"]
    with ServingEngine(scorer, tok, corpus.idf, cfg.max_len, max_batch=ENGINE_MAX_BATCH,
                       max_wait_s=ENGINE_MAX_WAIT_S) as eng, \
            SV.ThreadPoolServer(eng, num_workers=ENGINE_CLIENTS).start_background() as srv:
        with SV.Client(srv.address) as cl:
            for q, a in reqs[:SERVICE_WARM]:
                cl.get_score(q, a)
        results, lat = {}, {}

        def client(c: int) -> None:
            mine = engine_reqs[c::ENGINE_CLIENTS]
            out, ls = [], []
            with SV.Client(srv.address) as cl_:
                for q, a in mine:
                    t = time.perf_counter()
                    out.append(cl_.get_score(q, a))
                    ls.append(time.perf_counter() - t)
            results[c], lat[c] = (mine, out), ls

        threads = [threading.Thread(target=client, args=(c,)) for c in range(ENGINE_CLIENTS)]
        b0 = eng.batcher.stats()["batches"]
        K.reset_launches()
        calls0 = scorer.calls
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVICE_WAIT_S)
        wall = time.perf_counter() - t0
        launches, calls = K.launches, scorer.calls - calls0
        check(not any(t.is_alive() for t in threads) and len(results) == ENGINE_CLIENTS,
              "service: an engine client did not finish")
        stats = eng.stats()
        batches = stats["batches"] - b0
    n = sum(len(v) for v in lat.values())
    all_lat = [x for v in lat.values() for x in v]
    pairs = [p for mine, _ in results.values() for p in mine]
    got = np.asarray([x for _, out in results.values() for x in out])
    want = np.concatenate([SV.QuestionAnsweringHandler(scorer, tok, corpus.idf, cfg.max_len)
                           .get_scores(pairs[i:i + 256]) for i in range(0, len(pairs), 256)])
    err = float(abs(got - want).max())
    check(bool((abs(got - want) <= 1e-5 + 1e-4 * abs(want)).all()),
          f"service: engine RPC scores disagree with the scorer in process: {err:.3e}")
    check(launches == 2 * calls and calls == batches,
          f"service: the engine's {batches} batches made {calls} scorer calls and "
          f"{launches} conv launches")
    p50, p99 = _percentile(all_lat, 0.5) * 1e3, _percentile(all_lat, 0.99) * 1e3
    rows["engine"] = {"qps": n / wall, "p50_ms": p50, "p99_ms": p99,
                      "mean_batch": n / max(batches, 1), "launches": launches}
    log(f"service: table2 engine (ServingEngine pallas, max_batch={ENGINE_MAX_BATCH}, "
        f"max_wait_s={ENGINE_MAX_WAIT_S}, ThreadPoolServer {ENGINE_CLIENTS} workers, "
        f"{ENGINE_CLIENTS} client threads x {n // ENGINE_CLIENTS} RPCs): q/s={n / wall:.3f} "
        f"p50_ms={p50:.4f} p99_ms={p99:.4f} mean_batch={n / max(batches, 1):.3f} over "
        f"{int(batches)} batches; conv_launches={launches} in {calls} scorer calls; "
        f"max_abs_err_vs_in_process={err:.3e}")

    # ---- the remote targets against servers on the card ----
    ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
    server_ctx = PlanContext.from_world(cfg, tree, corpus, tok, index, device="cuda")
    pipe = ops.Retrieve(h=20) >> ops.Rerank("pallas") % 10
    queries = corpus.questions[-SERVICE_PLAN_Q:]
    handler = SV.QuestionAnsweringHandler(server_ctx.scorer_for("pallas"), tok, corpus.idf,
                                          cfg.max_len)
    engine = PipelineEngine(pipe, server_ctx, target="batched")
    plans = []
    with SV.ThreadPoolServer(handler, admission=AdmissionController(1024)
                             ).start_background() as srv, \
            SV.ThreadPoolServer(engine, admission=AdmissionController(
                SERVICE_PLAN_Q * engine.rows_per_query)).start_background() as psrv:
        try:
            plans = [plan(pipe, "local", ctx),
                     plan(pipe, "remote", ctx=ctx, remote=srv.address),
                     plan(pipe, "remote_pipeline", ctx=ctx, remote=psrv.address)]
            for p in plans:
                log(f"service: {p.describe()}")
            K.reset_launches()
            all_scorers = ctx.scorers() + server_ctx.scorers()
            calls0 = sum(s_.calls for s_ in all_scorers)
            t0 = time.perf_counter()
            verify_plans(plans, queries, tie_atol=TIE_ATOL)
            verify_s = time.perf_counter() - t0
            launches = K.launches
            calls = sum(s_.calls for s_ in all_scorers) - calls0
            check(launches > 0 and launches == 2 * calls,
                  f"service: the plans made {calls} pallas scorer calls and {launches} "
                  f"conv launches")
            log(f"service: local == remote == remote_pipeline on {len(queries)} unseen "
                f"questions (verify_plans, tie_atol={TIE_ATOL}) in {verify_s:.3f} s; "
                f"conv_launches={launches} in {calls} pallas scorer calls")
            timed = {}
            for p in plans:
                t = time.perf_counter()
                p.run_many(queries)
                timed[p.target] = len(queries) / (time.perf_counter() - t)
            log("service: the same questions again, q/s: "
                + " ".join(f"{k}={v:.3f}" for k, v in timed.items()))

            # a deadline already past sheds before any work
            with SV.Client(srv.address) as cl:
                try:
                    cl.get_score(*reqs[0], deadline_s=0.0)
                    shed = None
                except wire.ShedError as e:
                    shed = str(e)
                check(shed is not None and "expired" in shed,
                      f"service: a past deadline was not shed ({shed!r})")
                check(srv.stats()["shed_expired"] == 1.0,
                      "service: the admission controller counted no expired shed")
            log(f"service: a frame with a past deadline came back as ShedError ({shed})")

            # drain: in-flight work finishes, new work sheds, inflight reaches 0
            done = {}

            def ranking():
                with SV.Client(psrv.address) as cl_:
                    done["rankings"] = cl_.rank_batch(queries)

            th = threading.Thread(target=ranking)
            th.start()
            with SV.Client(psrv.address) as cl:
                t_end = time.perf_counter() + SERVICE_WAIT_S
                while psrv.state.inflight == 0 and th.is_alive() \
                        and time.perf_counter() < t_end:
                    time.sleep(0.0005)
                inflight = cl.drain()["inflight"]
                try:
                    cl.rank(queries[0])
                    drained_shed = None
                except wire.ShedError as e:
                    drained_shed = str(e)
                check(drained_shed is not None and "draining" in drained_shed,
                      f"service: a draining server took new work ({drained_shed!r})")
                while cl.health()["inflight"] > 0 and time.perf_counter() < t_end:
                    time.sleep(0.001)
                health = cl.health()
            th.join(timeout=SERVICE_WAIT_S)
            check(health["inflight"] == 0.0 and health["draining"] == 1.0,
                  f"service: drain left {health['inflight']} requests in flight")
            check(not th.is_alive() and len(done.get("rankings", [])) == len(queries),
                  "service: the in-flight ranking did not finish during the drain")
            log(f"service: drain acked with {inflight:.0f} in flight, shed new work "
                f"({drained_shed}), health inflight reached 0; the in-flight batch of "
                f"{len(queries)} finished")
        finally:
            for p in plans:
                p.close()
    return rows


# ------------------------------------------------------------------ launch --

def _rank_ids(rankings):
    return [[(d, s) for d, s, _ in r] for r in rankings]


def _same_rankings(got, want, what: str) -> float:
    """Rankings of (doc, sent, score) lists: the same ids, scores within
    rtol 1e-4 / atol 1e-5. Returns the largest score difference."""
    check(len(got) == len(want), f"{what}: {len(got)} rankings for {len(want)} queries")
    err = 0.0
    for g, w in zip(got, want):
        check([(d, s) for d, s, _ in g] == [(d, s) for d, s, _ in w],
              f"{what}: ranking {[(d, s) for d, s, _ in g]} differs from "
              f"{[(d, s) for d, s, _ in w]}")
        for (_, _, a), (_, _, b) in zip(g, w):
            check(abs(a - b) <= 1e-5 + 1e-4 * abs(b), f"{what}: score {a} against {b}")
            err = max(err, abs(a - b))
    return err


def _clients(n_threads: int, work, what: str) -> dict:
    """``n_threads`` threads each running ``work(c) -> [(latency_s, ...)]``;
    returns per-thread results, the wall time and the latencies."""
    results = {}

    def run(c):
        results[c] = work(c)

    threads = [threading.Thread(target=run, args=(c,)) for c in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=LAUNCH_WAIT_S)
    wall = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads) and len(results) == n_threads,
          f"launch: a {what} client did not finish")
    lat = [x[0] for v in results.values() for x in v]
    return {"results": results, "wall": wall, "n": len(lat),
            "qps": len(lat) / wall, "p50_ms": _percentile(lat, 0.5) * 1e3,
            "p99_ms": _percentile(lat, 0.99) * 1e3}


class _ServedTarget:
    """A live server as a ``RolloutController`` target: ``swap_version`` is
    MSG_SWAP, ``model_version`` MSG_VERSION, the canaries ``rank_batch``."""

    def __init__(self, client):
        self.client = client

    @property
    def model_version(self):
        return self.client.version()[0]

    def swap_version(self, version):
        return self.client.swap(version)[0]

    def rank_batch(self, queries):
        return self.client.rank_batch(queries)


def _launch_train(torch, cfg, world, tmp: Path) -> dict:
    """(a) Full-width sm-cnn trained on the card, its weights served by
    pallas against eager, a checkpoint restored on the CPU and published."""
    import functools

    from repro_torch.core import backends
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.data import qa
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.launch.world import build_world
    from repro_torch.models import sm_cnn
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import adamw
    from repro_torch.training.train_loop import Trainer

    tree, corpus, tok, _ = world

    def stream():
        ep = 0
        while True:
            yield from qa.pair_batches(corpus, tok, cfg.max_len, LAUNCH_BATCH, seed=ep)
            ep += 1

    tr = Trainer(functools.partial(sm_cnn.loss_fn, cfg=cfg), adamw(3e-3),
                 sm_cnn.params_from_numpy(tree, "cuda"))
    t0 = time.perf_counter()
    tr.run(stream(), max_steps=LAUNCH_TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [h["loss"] for h in tr.history]
    step_ms = [h["step_time_s"] * 1e3 for h in tr.history]
    check(all(math.isfinite(x) for x in losses), "launch: a training loss is not finite")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    check(last < first, f"launch: the loss did not fall ({first:.4f} -> {last:.4f})")
    check(all(t.device.type == "cuda" for t in tree_leaves(tr.params)),
          "launch: trained params left the card")
    log(f"launch: trained full-width {cfg.name} on the card: {LAUNCH_TRAIN_STEPS} "
        f"steps of batch {LAUNCH_BATCH} (Trainer + adamw(3e-3), eager autograd) in "
        f"{train_s:.3f} s; step_ms first={step_ms[0]:.3f} "
        f"median(2..{LAUNCH_TRAIN_STEPS})={statistics.median(step_ms[1:]):.4f} "
        f"p99={_percentile(step_ms[1:], 0.99):.4f}; loss mean of first 5 {first:.5f} "
        f"-> last 5 {last:.5f} (acc {tr.history[-1]['acc']:.4f})")

    # the trained weights served by the conv kernel against eager on the card
    rows = qa.make_batch(corpus, tok, cfg.max_len, corpus.pairs[:256])
    K.reset_launches()
    got = backends.make_scorer("pallas", tr.params, cfg, buckets=(256,),
                               device="cuda")(rows["q_tok"], rows["a_tok"], rows["feats"])
    launches = K.launches
    want = backends.make_scorer("eager", tr.params, cfg, buckets=(256,),
                                device="cuda")(rows["q_tok"], rows["a_tok"], rows["feats"])
    err = float(abs(got - want).max())
    check(bool((abs(got - want) <= 1e-5 + 1e-4 * abs(want)).all()) and launches == 2,
          f"launch: trained weights: pallas against eager {err:.3e}, {launches} launches")
    log(f"launch: trained weights served by pallas == eager on the card on 256 rows "
        f"(max_abs_err={err:.3e}, rtol 1e-4 atol 1e-5; {launches} conv launches)")

    # a checkpoint written from the card restores on the CPU bit-equal
    mgr = CheckpointManager(str(tmp / "ckpt"))
    mgr.save(tr.step, tr.params, tr.opt_state)
    cpu = lambda t: torch.zeros_like(t, device="cpu")  # noqa: E731
    params, opt, step = mgr.restore(tree_map(cpu, tr.params), tree_map(cpu, tr.opt_state))
    same = all(torch.equal(a, b.cpu()) for a, b in
               zip(tree_leaves(params) + tree_leaves(opt),
                   tree_leaves(tr.params) + tree_leaves(tr.opt_state)))
    check(same and step == LAUNCH_TRAIN_STEPS,
          "launch: the checkpoint did not restore on the CPU bit-equal")
    reg = ModelRegistry(str(tmp / "registry"))
    v_trained = mgr.publish_to_registry(reg).version_id
    v_seed = reg.publish(tree, model=cfg.name).version_id
    check(v_trained == reg.publish(params, model=cfg.name).version_id != v_seed,
          "launch: publish_checkpoint's id is not the id of the same weights")
    log(f"launch: checkpoint of step {step} written from the card restored on the "
        f"CPU bit-equal (params + adamw state, {len(tree_leaves(opt))} tensors); "
        f"published to a registry as {v_trained} (seed weights {v_seed})")

    t0 = time.perf_counter()
    lw = build_world(device="cuda")
    torch.cuda.synchronize()
    world_s = time.perf_counter() - t0
    log(f"launch: build_world() (the launcher's world, {lw[0].name}, 60 steps) on the "
        f"card in {world_s:.3f} s")
    return {"params": tr.params, "registry": reg, "v_seed": v_seed,
            "v_trained": v_trained, "step_ms": statistics.median(step_ms[1:]),
            "first_step_ms": step_ms[0], "train_s": train_s, "world_s": world_s,
            "loss": (first, last), "launcher_world": lw}


def _launch_pool(torch, cfg, world, params, service: dict) -> dict:
    """(b) ReplicaPools of 2 pallas and 2 aot replicas behind a
    ThreadPoolServer under 8 client threads with pairs of their own."""
    import numpy as np

    from repro_torch.core import backends
    from repro_torch.core import service as SV
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving.cluster import ReplicaPool

    _, corpus, tok, _ = world
    pairs = [(corpus.questions[qi], corpus.documents[di][si])
             for qi, di, si, _ in corpus.pairs[:LAUNCH_CLIENTS * CONCURRENT_RPCS]]
    ref = SV.QuestionAnsweringHandler(
        backends.make_scorer("eager", params, cfg, buckets=BACKEND_BUCKETS, device="cuda"),
        tok, corpus.idf, cfg.max_len)
    want = np.concatenate([ref.get_scores(pairs[i:i + 256])
                           for i in range(0, len(pairs), 256)])
    rows = {}
    for name in POOL_BACKENDS:
        t0 = time.perf_counter()
        pool = ReplicaPool.build(name, params, cfg, tok, corpus.idf,
                                 n_replicas=POOL_REPLICAS, buckets=BACKEND_BUCKETS,
                                 device="cuda")
        build_s = time.perf_counter() - t0
        with pool, SV.ThreadPoolServer(pool, num_workers=LAUNCH_CLIENTS
                                       ).start_background() as srv:
            with SV.Client(srv.address) as cl:
                for q, a in pairs[:SERVICE_WARM]:
                    cl.get_score(q, a)
            torch.cuda.synchronize()

            def work(c):
                out = []
                with SV.Client(srv.address) as cl_:
                    for i in range(c, len(pairs), LAUNCH_CLIENTS):
                        t = time.perf_counter()
                        score = cl_.get_score(*pairs[i])
                        out.append((time.perf_counter() - t, i, score))
                return out

            # ---- the launch path, counted ----
            K.reset_launches()
            calls0 = sum(r.batcher.scorer.calls for r in pool.replicas)
            run = _clients(LAUNCH_CLIENTS, work, f"{name} pool")
            launches = K.launches
            calls = sum(r.batcher.scorer.calls for r in pool.replicas) - calls0
            # ---- end of the counted run ----
            stats = pool.stats()
        err = 0.0
        for out in run["results"].values():
            for _, i, score in out:
                check(abs(score - want[i]) <= 1e-5 + 1e-4 * abs(want[i]),
                      f"launch: {name} pool answered pair {i} with {score}, its score "
                      f"in process is {want[i]}")
                err = max(err, abs(score - want[i]))
        check(run["n"] == len(pairs), f"launch: {name} pool answered {run['n']} RPCs")
        check(calls > 0 and launches == (2 * calls if name == "pallas" else 0),
              f"launch: {name} pool: {launches} conv launches in {calls} scorer calls")
        per_rep = [int(stats[f"replica{i}_requests"]) for i in range(POOL_REPLICAS)]
        single = service[name]["concurrent"]
        rows[name] = dict(qps=run["qps"], p50_ms=run["p50_ms"], p99_ms=run["p99_ms"],
                          launches=launches, calls=calls, build_s=build_s,
                          mean_batch=run["n"] / calls)
        log(f"launch: pool {name} x{POOL_REPLICAS} (built in {build_s:.3f} s) behind a "
            f"ThreadPoolServer, {LAUNCH_CLIENTS} client threads x {CONCURRENT_RPCS} "
            f"get_score RPCs of pairs of their own: q/s={run['qps']:.3f} "
            f"p50_ms={run['p50_ms']:.4f} p99_ms={run['p99_ms']:.4f} (one {name} scorer "
            f"behind a ThreadPoolServer, service phase: q/s={single['qps']:.3f} "
            f"p50_ms={single['p50_ms']:.4f} p99_ms={single['p99_ms']:.4f}); requests a "
            f"replica {per_rep}, {calls} scorer calls (mean batch "
            f"{run['n'] / calls:.3f}), conv_launches={launches}; every reply its own "
            f"pair's score (max_abs_err_vs_eager_in_process={err:.3e})")
    return rows


def _launch_rollout(torch, cfg, world, trained: dict) -> dict:
    """(c) Shadow, A/B and a guardrailed hot swap over MSG_SWAP between two
    registry versions of the full-width model, on the card."""
    import numpy as np

    from repro_torch.core import ops
    from repro_torch.core import service as SV
    from repro_torch.core.plan import PlanContext
    from repro_torch.core.treepath import tree_map
    from repro_torch.kernels import sm_cnn_conv as K
    from repro_torch.serving import telemetry
    from repro_torch.serving.engine import PipelineEngine
    from repro_torch.serving.rollout import ABEngine, RolloutController, ShadowEngine

    tree, corpus, tok, index = world
    reg, va, vb = trained["registry"], trained["v_seed"], trained["v_trained"]
    pipe = ops.Retrieve(h=20) >> ops.Rerank("pallas") % 10
    queries = corpus.questions[:ROLLOUT_Q]

    def engine(version):
        ctx = PlanContext.from_world(cfg, None, corpus, tok, index, registry=reg,
                                     model_version=version, device="cuda")
        return PipelineEngine(pipe, ctx, target="batched")

    solo = {v: engine(v).rank_batch(queries) for v in (va, vb)}
    differ = sum(a != b for a, b in zip(_rank_ids(solo[va]), _rank_ids(solo[vb])))
    check(differ > 0, "launch: the two versions rank every query alike")
    telemetry.reset_all()
    K.reset_launches()
    # ---- the rollout path, counted ----
    shadow = ShadowEngine(engine(va), engine(vb), fraction=1.0, max_pending=4)
    out = shadow.rank_batch(queries)
    check(shadow.drain(LAUNCH_WAIT_S), "launch: the shadow did not drain")
    err = _same_rankings(out, solo[va], "shadow primary")
    snap = telemetry.get_registry().snapshot()
    mirrored = sum(v for k, v in snap.items() if k.startswith("shadow_queries") and vb in k)
    changed = sum(v for k, v in snap.items()
                  if k.startswith("shadow_top1_changed") and vb in k)
    check(mirrored == len(queries) and not any(k.startswith("shadow_errors") for k in snap),
          f"launch: the shadow mirrored {mirrored} of {len(queries)} queries")
    log(f"launch: ShadowEngine(primary {va}, candidate {vb}, fraction 1.0) on "
        f"{len(queries)} questions: the primary's rankings == {va} alone "
        f"(max_abs_err={err:.3e}); {int(mirrored)} mirrored to {vb}, top-1 changed on "
        f"{int(changed)}; the versions' rankings differ on {differ} questions")

    ab = ABEngine(engine(va), engine(vb), split_pct=50.0)
    arms = [ab.arm_of(q) for q in queries]
    got = ab.rank_batch(queries)
    for i, (r, arm) in enumerate(zip(got, arms)):
        _same_rankings([r], [solo[vb if arm == "b" else va][i]], f"A/B arm {arm}")
    check({"a", "b"} == set(arms), "launch: the A/B split used one arm")
    snap = telemetry.get_registry().snapshot()
    per_arm = {v: sum(x for k, x in snap.items() if k.startswith("ab_queries") and v in k)
               for v in (va, vb)}
    check(per_arm == {va: arms.count("a"), vb: arms.count("b")},
          f"launch: ab_queries per version {per_arm}")
    log(f"launch: ABEngine 50/50: {arms.count('a')} questions to {va}, "
        f"{arms.count('b')} to {vb}; every reply == its arm's version alone")

    vbad = reg.publish(tree_map(lambda x: np.full(np.shape(x), np.nan, np.float32), tree),
                       model="broken").version_id
    with SV.ThreadPoolServer(engine(va), num_workers=2).start_background() as srv, \
            SV.Client(srv.address) as cl:
        ctrl = RolloutController(_ServedTarget(cl), canary_queries=queries[:4],
                                 canary_passes=1)
        bad = ctrl.hot_swap(vbad)
        check(bad.rolled_back and cl.version() == (va, "active"),
              f"launch: a NaN candidate was not rolled back ({bad})")
        good = ctrl.hot_swap(vb)
        check(good.swapped and cl.version() == (vb, "active"),
              f"launch: the trained version did not land ({good})")
        served = cl.rank_batch(queries)
    launches = K.launches
    # ---- end of the counted run ----
    err = _same_rankings(served, solo[vb], "after hot_swap")
    check(launches > 0, "launch: the rollout launched the conv kernel no time")
    log(f"launch: RolloutController.hot_swap through MSG_SWAP on a live ThreadPoolServer: "
        f"NaN candidate {vbad} rolled back ({bad.reason}); {vb} swapped in "
        f"{good.swap_ms:.3f} ms (canary p99 {good.baseline.p99_ms:.3f} -> "
        f"{good.candidate.p99_ms:.3f} ms); the server's rankings == {vb} alone "
        f"(max_abs_err={err:.3e}); conv_launches in the rollout runs={launches}")
    return {"launches": launches, "swap_ms": good.swap_ms}


def _read_ready(proc, timeout_s: float):
    found = {}
    tail = []

    def read():
        for line in proc.stdout:
            tail.append(line.rstrip())
            if line.startswith("FABRIC_READY "):
                _, host, port = line.split()
                found["address"] = (host, int(port))
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout_s)
    check("address" in found, f"launch: the launcher never printed FABRIC_READY: {tail[-20:]}")
    return found["address"]


def _launch_cli() -> dict:
    """(d) The launcher as users start it: --describe, then a pipeline
    server, ranked through the port's Client, then --drain."""
    from repro_torch.core import service as SV
    from repro_torch.data import qa

    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-u", "-m", "repro_torch.launch.serve"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd + ["--describe", "--device", "cuda"], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=LAUNCH_WAIT_S)
    describe_s = time.perf_counter() - t0
    check(out.returncode == 0, f"launch: --describe failed: {out.stderr[-2000:]}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 5 and lines[1].lstrip().startswith("local@cuda:")
          and lines[4].lstrip().startswith("remote_pipeline:"),
          f"launch: --describe printed {lines}")
    for line in lines:
        log(f"launch: describe | {line}")
    log(f"launch: python -m repro_torch.launch.serve --describe --device cuda "
        f"(backend aot) in {describe_s:.3f} s")

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + ["--serve-pipeline", "--server", "threadpool",
                                   "--backend", "pallas", "--device", "cuda", "--port", "0"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=str(ROOT))
    try:
        host, port = _read_ready(proc, LAUNCH_WAIT_S)
        ready_s = time.perf_counter() - t0
        questions = qa.generate_corpus(n_docs=80, n_questions=60, seed=0).questions
        with SV.Client((host, port)) as cl:
            rankings = cl.rank_batch(questions[:32])
            version = cl.version()
        check(len(rankings) == 32 and sum(bool(r) for r in rankings) > 16,
              "launch: the launched server ranked too few questions")
        for r in rankings:
            check(all(math.isfinite(s) and 0.0 <= s <= 1.0 for _, _, s in r)
                  and [s for _, _, s in r] == sorted((s for _, _, s in r), reverse=True),
                  f"launch: a ranking is not in descending probabilities: {r}")
        drain = subprocess.run(cmd + ["--drain", f"{host}:{port}"], env=env, cwd=str(ROOT),
                               capture_output=True, text=True, timeout=LAUNCH_WAIT_S)
        check(drain.returncode == 0 and "draining=1" in drain.stdout
              and "inflight=0" in drain.stdout,
              f"launch: --drain printed {drain.stdout!r} {drain.stderr[-500:]!r}")
        log(f"launch: python -m repro_torch.launch.serve --serve-pipeline --server "
            f"threadpool --backend pallas --device cuda: FABRIC_READY after "
            f"{ready_s:.3f} s; rank_batch of 32 questions from the launcher's world: "
            f"{sum(bool(r) for r in rankings)} ranked, descending probabilities; "
            f"version {version}; --drain: {drain.stdout.strip()}")
    finally:
        proc.terminate()
        try:
            proc.wait(LAUNCH_WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(LAUNCH_WAIT_S)
    return {"describe_s": describe_s, "ready_s": ready_s}


def _launch_fabric(trained: dict, tmp: Path) -> dict:
    """(e) The fabric: 1 and then 4 worker processes serving one registry
    version of the launcher's world with pallas on the card, against one
    in-process ThreadPoolServer over the same engine."""
    from repro_torch.core import service as SV
    from repro_torch.core.plan import PlanContext
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.launch import serve
    from repro_torch.serving.engine import PipelineEngine
    from repro_torch.serving.fabric import Fabric

    cfg, params, corpus, tok, index, _ = trained["launcher_world"]
    reg_dir = str(tmp / "fabric_registry")
    reg = ModelRegistry(reg_dir)
    vid = reg.publish(params, model=cfg.name).version_id
    ctx = PlanContext.from_world(cfg, params, corpus, tok, index, buckets=(1, 8, 64, 256),
                                 registry=reg, model_version=vid, device="cuda")
    engine = PipelineEngine(serve.canonical_pipeline("pallas"), ctx)
    queries = corpus.questions
    want = engine.rank_batch(queries)
    want_of = dict(zip(queries, want))

    def load(rank_batch_of):
        def work(c):
            out = []
            for i in range(FABRIC_RPCS):
                q = queries[(c * FABRIC_RPCS + i) % len(queries)]
                t = time.perf_counter()
                r = rank_batch_of(c)([q])
                out.append((time.perf_counter() - t, q, r[0]))
            return out
        return work

    def held(run, what):
        err = 0.0
        for out in run["results"].values():
            for _, q, r in out:
                err = max(err, _same_rankings([r], [want_of[q]], what))
        return err

    rows = {}
    with SV.ThreadPoolServer(engine, num_workers=LAUNCH_CLIENTS).start_background() as srv:
        clients = [SV.Client(srv.address) for _ in range(LAUNCH_CLIENTS)]
        try:
            for cl in clients:
                cl.rank_batch(queries[:2])
            run = _clients(LAUNCH_CLIENTS, load(lambda c: clients[c].rank_batch),
                           "single-server")
        finally:
            for cl in clients:
                cl.close()
    err = held(run, "one ThreadPoolServer")
    rows["server"] = run
    log(f"launch: one process: ThreadPoolServer({LAUNCH_CLIENTS} workers) over "
        f"PipelineEngine({serve.canonical_pipeline('pallas')!r}) on {vid}, "
        f"{LAUNCH_CLIENTS} client threads (a Client each) x {FABRIC_RPCS} rank_batch "
        f"RPCs of one question: q/s={run['qps']:.3f} p50_ms={run['p50_ms']:.4f} "
        f"p99_ms={run['p99_ms']:.4f}; every ranking == in process "
        f"(max_abs_err={err:.3e})")

    for n in FABRIC_WORKERS:
        # a worker serves one connection a thread: the router's two and as
        # many clients as there are threads
        fab = Fabric(n_workers=n, backend="pallas", train_steps=60, device="cuda",
                     spawn_timeout_s=LAUNCH_WAIT_S, worker_threads=LAUNCH_CLIENTS + 2,
                     extra_args=("--registry", reg_dir, "--model-version", vid))
        t0 = time.perf_counter()
        with fab:
            up_s = time.perf_counter() - t0
            for ep in fab.router._endpoints:
                check(ep.version() == (vid, "active"), "launch: a worker serves another "
                      "version")
                got = [r for i in range(0, len(queries), FABRIC_CHUNK)
                       for r in ep.client.rank_batch(queries[i:i + FABRIC_CHUNK])]
                _same_rankings(got, want, f"fabric worker {ep.slot} of {n}")
            run = _clients(LAUNCH_CLIENTS, load(lambda c: fab.router.rank_batch),
                           f"fabric x{n}")
            stats = fab.stats()
            # the same load with no router: a Client a thread, the threads
            # spread over the workers
            direct = [SV.Client(fab.workers[c % n].address) for c in range(LAUNCH_CLIENTS)]
            try:
                run_d = _clients(LAUNCH_CLIENTS, load(lambda c: direct[c].rank_batch),
                                 f"fabric x{n} direct")
            finally:
                for cl in direct:
                    cl.close()
            per_worker = {i: m.get("engine_rank_queries{model_version=" + vid + "}", 0.0)
                          for i, m in fab.worker_metrics().items()}
        err = max(held(run, f"fabric x{n}"), held(run_d, f"fabric x{n} direct"))
        check(stats["alive_workers"] == n and stats["respawns"] == 0,
              f"launch: fabric x{n}: {stats}")
        rows[n] = dict(run, up_s=up_s, direct=run_d)
        log(f"launch: Fabric(n_workers={n}, backend pallas, --registry, --model-version "
            f"{vid}, --device cuda, --train-steps 60): up in {up_s:.3f} s (spawn to the "
            f"last FABRIC_READY: torch import, CUDA context, kernel load, training); "
            f"every worker's rankings of the world's {len(queries)} questions == the "
            f"in-process pallas plan on {vid}; router under {LAUNCH_CLIENTS} client "
            f"threads x {FABRIC_RPCS} rank_batch RPCs of one question: "
            f"q/s={run['qps']:.3f} p50_ms={run['p50_ms']:.4f} p99_ms={run['p99_ms']:.4f} "
            f"(hedged {int(stats['router_hedged'])}, hedge wins "
            f"{int(stats['router_hedge_wins'])}); queries a worker {per_worker}; "
            f"without the router, a Client a thread spread over the workers: "
            f"q/s={run_d['qps']:.3f} p50_ms={run_d['p50_ms']:.4f} "
            f"p99_ms={run_d['p99_ms']:.4f}; every reply == in process "
            f"(max_abs_err={err:.3e})")
    hi, lo = rows[FABRIC_WORKERS[-1]], rows[FABRIC_WORKERS[0]]
    log(f"launch: fabric x{FABRIC_WORKERS[-1]} against x{FABRIC_WORKERS[0]}: q/s "
        f"{hi['qps'] / lo['qps']:.3f}x through the router, "
        f"{hi['direct']['qps'] / lo['direct']['qps']:.3f}x without it; against one "
        f"in-process ThreadPoolServer: {hi['qps'] / rows['server']['qps']:.3f}x through "
        f"the router, {hi['direct']['qps'] / rows['server']['qps']:.3f}x without it")
    return rows


def phase_launch(torch, cfg, world, service: dict) -> dict:
    """The serving launcher's stack on the card: training, ReplicaPool,
    rollout, the CLI as users start it, and the fabric of worker processes."""
    import shutil
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="launch_", dir=str(ROOT / "build")))
    try:
        trained = _launch_train(torch, cfg, world, tmp)
        pool = _launch_pool(torch, cfg, world, trained["params"], service)
        rollout = _launch_rollout(torch, cfg, world, trained)
        cli = _launch_cli()
        fabric = _launch_fabric(trained, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": pool["pallas"]["launches"] + rollout["launches"],
            "pool": pool, "rollout": rollout, "cli": cli, "fabric": fabric,
            "step_ms": trained["step_ms"], "world_s": trained["world_s"]}


# ------------------------------------------------------------- attn-kernel --

def attention_bound(b: int, s: int, h: int, hkv: int, d: int, dtype: str):
    """Least time for causal GQA attention on the card: q, k, v read once
    and o written once at the memory rate, against the products the
    function needs at the dtype's peak: two products of d terms for each
    visible (query, key) pair, S(S+1)/2 of them per query head (the causal
    half with the diagonal). Products on masked pairs are not needed, so
    they are not counted."""
    es = 4 if dtype == "float32" else 2
    n_bytes = es * b * s * d * (2 * h + 2 * hkv)
    flops = 4 * b * h * d * s * (s + 1) // 2
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), \
        n_bytes, flops


def _attn_agrees(torch, got, want, dtype: str, what: str) -> float:
    """Holds ``got`` against ``want`` at the dtype's absolute tolerance and
    at its tolerance on the error's norm over ``want``'s; returns the max
    absolute error."""
    diff = got.float() - want.float()
    err = diff.abs().max().item()
    rel = (torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want.float())).item()
    ok = (math.isfinite(err) and err <= ATTN_TOLERANCE[dtype]
          and math.isfinite(rel) and rel <= ATTN_REL_TOLERANCE[dtype])
    log(f"attn-kernel: {what} {dtype}: max_abs_err={err:.3e} tol={ATTN_TOLERANCE[dtype]} "
        f"rel_norm_err={rel:.3e} tol={ATTN_REL_TOLERANCE[dtype]} {'ok' if ok else 'FAIL'}")
    check(ok, f"attention: {what} {dtype} disagree: max_abs_err {err}, rel_norm_err {rel}")
    return err


def phase_attn_kernel(torch, cfg) -> dict:
    """The attention kernel against its plain version on the card at
    qwen3-0.6b's widths, then its times, the plain version's, SDPA's as a
    yardstick, and the bound.

    Inputs are standard normal (randn), so the softmax stays spread over
    the keys, not one-hot, and the outputs are averages of many rows of v
    that a wrong weight or a wrong KV head would move. Every check holds
    the max absolute error and the error's norm relative to the output's.
    The timed shapes are checked too: against the plain version at
    (8, 2048); at (1, 32768), where its scores would not fit, on the first
    and last ATTN_SLICE_ROWS query rows against all keys; and SDPA against
    the kernel at each.
    """
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(4321)

    def inputs(b, s, dtype):
        dt = getattr(torch, dtype)
        return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda").to(dt)
                     for n in (h, hkv, hkv))

    routes = {}
    for dtype in ("float32", "bfloat16"):
        info = routes[dtype] = FA.route_info(getattr(torch, dtype))
        log(f"attn-kernel: {dtype} route: stage {info['stage']} ({info['design']}), "
            f"{info['registers']} registers and {info['local_bytes']} local (spill) bytes a "
            f"thread, shared memory {info['static_smem']} B static + {info['dynamic_smem']} B "
            f"dynamic a block, {info['threads']} threads a block, {info['blocks_per_sm']} "
            f"blocks resident on an SM")

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    checks = [(b, s, dtype) for b, s in ATTN_SHAPES for dtype in ("float32", "bfloat16")]
    checks += [(2, s, "bfloat16") for s in ATTN_DIAGONAL_S]
    for b, s, dtype in checks:
        q, k, v = inputs(b, s, dtype)
        got = FA.flash_attention(q, k, v)
        want = FA.flash_attention_plain(q, k, v)
        err = _attn_agrees(torch, got, want, dtype,
                           f"kernel vs plain B={b} S={s} H={h} Hkv={hkv} d={d}")
        max_err[dtype] = max(max_err[dtype], err)
        del q, k, v, got, want
    torch.cuda.empty_cache()

    timings = {}
    for b, s, dtype in ATTN_TIMED:
        q, k, v = inputs(b, s, dtype)
        # the yardstick's (B, H, S, d) layouts are made once, outside the timing
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        fns = {"kernel": lambda: FA.flash_attention(q, k, v), "library": library}
        got = FA.flash_attention(q, k, v)
        if s <= PLAIN_MAX_S:
            fns["plain"] = lambda: FA.flash_attention_plain(q, k, v)
            err = _attn_agrees(torch, got, FA.flash_attention_plain(q, k, v), dtype,
                               f"kernel vs plain B={b} S={s}")
        else:
            n = ATTN_SLICE_ROWS
            err = max(_attn_agrees(torch, got[:, :n], FA.flash_attention_plain(
                          q[:, :n], k, v), dtype,
                          f"kernel vs plain B={b} S={s} query rows 0..{n - 1}"),
                      _attn_agrees(torch, got[:, s - n:], FA.flash_attention_plain(
                          q[:, s - n:], k, v, q_start=s - n), dtype,
                          f"kernel vs plain B={b} S={s} query rows {s - n}..{s - 1}"))
        max_err[dtype] = max(max_err[dtype], err)
        lib_err = _attn_agrees(torch, library().transpose(1, 2), got, dtype,
                               f"SDPA vs kernel B={b} S={s}")
        del got
        iters = 20 if s <= PLAIN_MAX_S else 2
        t = _time_alternating(torch, fns, iters=iters)
        dev_ms = _queued_ms(torch, fns["kernel"], iters)
        bound_ms, bound_by, n_bytes, flops = attention_bound(b, s, h, hkv, d, dtype)
        timings[(b, s, dtype)] = dict(t, bound_ms=bound_ms, bound_by=bound_by,
                                      device_ms=dev_ms)
        plain = f"{t['plain']:.5f}" if "plain" in t else "not run (scores too large)"
        log(f"attn-kernel: B={b} S={s} {dtype} kernel_ms={t['kernel']:.5f} "
            f"kernel_device_ms={dev_ms:.5f} "
            f"plain_ms={plain} library_ms={t['library']:.5f} (SDPA causal GQA, "
            f"max_abs_err vs kernel {lib_err:.3e}) bound_ms={bound_ms:.5f} "
            f"({bound_by}: {flops / 1e12:.4f} TFLOP at {PEAK_FLOPS[dtype] / 1e12:.0f} "
            f"TFLOP/s, {n_bytes / 1e6:.3f} MB at 3.35 TB/s) "
            f"share_of_bound={bound_ms / t['kernel']:.4f} "
            f"achieved_tflops={flops / t['kernel'] / 1e9:.3f}")
        del q, k, v, qt, kt, vt, fns
        torch.cuda.empty_cache()
    return {"max_err": max_err, "timings": timings, "routes": routes}


# ---------------------------------------------------------------- lm-check --

def phase_lm_check(torch, cfg, seed: int) -> None:
    """The LM path against itself on the card in float32 (TF32 off): (a)
    prefill with the kernel ("flash") against plain torch ("chunked"), and
    (b) decode at position S after a prefill of S tokens against forward
    over S+1 tokens."""
    import dataclasses

    from repro_torch.data import lm as lm_data
    from repro_torch.models import transformer as tfm

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tfm.init_lm(cfg32, torch.Generator("cuda").manual_seed(seed), "cuda")
    toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, CHECK_B, CHECK_S + 1, seed=seed))["tokens"]).cuda()
    prompt = toks[:, :CHECK_S]

    # (a) the two attentions differ only in the order of float32 sums (the
    # kernel's online softmax against materialised scores), about 1e-6 per
    # layer; 28 layers carry that into logits of std about 0.6, so the
    # repo's score rtol 1e-4 with atol 1e-4 (not 1e-5) bounds it
    flash_l, flash_c = tfm.prefill(params, prompt, cfg32)
    chunk_l, chunk_c = tfm.prefill(params, prompt,
                                   dataclasses.replace(cfg32, attn_impl="chunked"))
    errs = {"logits": (flash_l - chunk_l).abs().max().item()}
    ok = torch.allclose(flash_l, chunk_l, rtol=1e-4, atol=1e-4)
    for key in ("k", "v"):
        errs[key] = (flash_c[key] - chunk_c[key]).abs().max().item()
        ok = ok and torch.allclose(flash_c[key], chunk_c[key], rtol=1e-4, atol=1e-4)
    log(f"lm-check: float32 prefill B={CHECK_B} S={CHECK_S} flash (kernel) vs chunked "
        f"(plain torch): max_abs_err logits={errs['logits']:.3e} cache k={errs['k']:.3e} "
        f"v={errs['v']:.3e} (rtol=1e-4 atol=1e-4; logits std "
        f"{flash_l.float().std().item():.4f}) {'ok' if ok else 'FAIL'}")
    check(ok, f"flash and chunked prefills disagree in float32: {errs}")
    del chunk_l, chunk_c

    # (b) tests/test_arch_smoke.py::test_lm_prefill_decode_consistency's check
    full, _ = tfm.forward(params, toks, cfg32)
    cache = tfm.init_cache(cfg32, CHECK_B, CHECK_S + 8)
    for key in ("k", "v"):
        cache[key][:, :, :CHECK_S] = flash_c[key]
    pos = torch.full((CHECK_B,), CHECK_S, dtype=torch.int32, device="cuda")
    lg, _ = tfm.decode_step(params, cache, toks[:, CHECK_S], pos, cfg32)
    err = (lg - full[:, -1]).abs().max().item()
    ok = torch.allclose(lg, full[:, -1], rtol=2e-2, atol=2e-2)
    err_p = (flash_l - full[:, -2]).abs().max().item()
    ok = ok and torch.allclose(flash_l, full[:, -2], rtol=2e-2, atol=2e-2)
    log(f"lm-check: float32 decode at position {CHECK_S} vs forward over {CHECK_S + 1} "
        f"tokens: max_abs_err={err:.3e}; prefill's last logits vs forward: "
        f"{err_p:.3e} (rtol=atol=2e-2) {'ok' if ok else 'FAIL'}")
    check(ok, f"decode after prefill disagrees with forward: {err}, {err_p}")
    del params, flash_l, flash_c, full, cache, lg
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------- lm --

def phase_lm(torch, cfg, seed: int) -> dict:
    """qwen3-0.6b's serving path at full width in bfloat16: prefill of
    8 x 2048 tokens, the cache copied into a 2048+32 cache, 32 greedy decode
    steps, then a prefill of 1 x 32768. The attention kernel's launch count
    is set to 0 just before and read just after, and must be 28 per
    prefill; decode launches it never."""
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as tfm

    sync = torch.cuda.synchronize
    t0 = time.perf_counter()
    params = tfm.init_lm(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, LM_BATCH, LM_SEQ, seed=seed))["tokens"]).cuda()
    long_toks = torch.from_numpy(next(lm_data.token_batches(
        cfg.vocab_size, 1, LM_LONG, seed=seed + 1))["tokens"]).cuda()
    sync()
    log(f"lm: cfg={cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} "
        f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_head={cfg.d_head} d_ff={cfg.d_ff} "
        f"vocab={cfg.vocab_size} {cfg.dtype} params={n_params} "
        f"({n_params * 2 / 1e9:.3f} GB); setup {time.perf_counter() - t0:.3f} s")
    tfm.prefill(params, toks[:, :128], cfg)           # warm-up: handles, first launches
    sync()

    # ---- the main path, counted ----
    FA.reset_launches()
    n_full = 0
    prefill_s = []
    for _ in range(3):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        logits, pcache = tfm.prefill(params, toks, cfg)
        sync()
        prefill_s.append(time.perf_counter() - t)
        n_full += 1
    peak8 = torch.cuda.max_memory_allocated()
    check(tuple(logits.shape) == (LM_BATCH, cfg.vocab_padded)
          and bool(torch.isfinite(logits).all()), "prefill logits not finite (B, V)")
    cache = tfm.init_cache(cfg, LM_BATCH, LM_SEQ + LM_DECODE)
    for key in ("k", "v"):
        cache[key][:, :, :LM_SEQ] = pcache[key]
    del pcache
    tok = logits.argmax(-1)
    pos = torch.full((LM_BATCH,), LM_SEQ, dtype=torch.int32, device="cuda")
    step_s, generated = [], [tok]
    for _ in range(LM_DECODE):
        t = time.perf_counter()
        logits, cache = tfm.decode_step(params, cache, tok, pos, cfg)
        tok = logits.argmax(-1)
        sync()
        step_s.append(time.perf_counter() - t)
        check(bool(torch.isfinite(logits).all()), "decode logits not finite")
        generated.append(tok)
        pos = pos + 1
    decode_launches = FA.launches - cfg.n_layers * n_full
    long_s = []
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        long_logits, long_cache = tfm.prefill(params, long_toks, cfg)
        sync()
        long_s.append(time.perf_counter() - t)
        n_full += 1
    peak_long = torch.cuda.max_memory_allocated()
    launches = FA.launches
    # ---- end of the counted run ----

    check(tuple(long_logits.shape) == (1, cfg.vocab_padded)
          and bool(torch.isfinite(long_logits).all()), "32k prefill logits not finite")
    check(tuple(long_cache["k"].shape) == (cfg.n_layers, 1, LM_LONG, cfg.n_kv_heads,
                                           cfg.d_head), "32k cache shape")
    gen_toks = torch.stack(generated, 1)
    check(bool(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all()),
          "a greedy token outside the vocabulary")
    kv_bytes = cfg.n_layers * cfg.n_kv_heads * cfg.d_head * 2 * 2
    med8, best_long = statistics.median(prefill_s), min(long_s)
    med_step = statistics.median(step_s)
    log(f"lm: prefill B={LM_BATCH} S={LM_SEQ}: {','.join(f'{x * 1e3:.3f}' for x in prefill_s)} "
        f"ms, median {med8 * 1e3:.3f} ms, {LM_BATCH * LM_SEQ / med8:.1f} tokens/s; "
        f"KV cache {LM_BATCH * LM_SEQ * kv_bytes / 1e9:.3f} GB ({kv_bytes} B a token); "
        f"peak allocated {peak8 / 1e9:.3f} GB")
    log(f"lm: decode B={LM_BATCH} from position {LM_SEQ}, {LM_DECODE} greedy steps: "
        f"median {med_step * 1e3:.3f} ms/step (min {min(step_s) * 1e3:.3f}, max "
        f"{max(step_s) * 1e3:.3f}), {LM_BATCH / med_step:.1f} tokens/s; first tokens of "
        f"row 0: {gen_toks[0, :8].tolist()}")
    log(f"lm: prefill B=1 S={LM_LONG}: {','.join(f'{x * 1e3:.3f}' for x in long_s)} ms, "
        f"best {best_long * 1e3:.3f} ms, {LM_LONG / best_long:.1f} tokens/s; KV cache "
        f"{LM_LONG * kv_bytes / 1e9:.3f} GB; peak allocated {peak_long / 1e9:.3f} GB")
    log(f"lm: flash_attention launches={launches} over {n_full} prefill calls "
        f"(decode launched it {decode_launches} times)")
    check(launches > 0, "the LM path launched the attention kernel no time")
    check(launches == cfg.n_layers * n_full,
          f"expected {cfg.n_layers} attention launches per prefill, got {launches} "
          f"for {n_full} prefills")
    check(decode_launches == 0, f"decode launched the attention kernel {decode_launches} times")
    del long_logits, long_cache
    torch.cuda.empty_cache()

    # busy shares, outside the counted run: one B=8 prefill, then 8 decode
    # steps redone on the last 8 positions with the tokens they had
    log(f"lm: prefill B={LM_BATCH} S={LM_SEQ} "
        f"{_busy_share(torch, lambda: tfm.prefill(params, toks, cfg), 'flash_attention')}")
    pos0 = LM_SEQ + LM_DECODE - 8

    def eight_steps():
        for i in range(8):
            tfm.decode_step(params, cache, gen_toks[:, LM_DECODE - 8 + i],
                            torch.full((LM_BATCH,), pos0 + i, dtype=torch.int32,
                                       device="cuda"), cfg)

    log(f"lm: 8 decode steps B={LM_BATCH} {_busy_share(torch, eight_steps, 'flash_attention')}")
    del params, cache
    torch.cuda.empty_cache()
    return {"launches": launches}


# ---------------------------------------------------------------- attn-bwd --

def attention_bwd_bound(b: int, s: int, h: int, hkv: int, d: int, dtype: str):
    """Least time for the attention's gradient on the card: q, k, v, o, do
    and lse read once, dq, dk, dv written once, at the memory rate, against
    the four products of d terms it needs for each visible (query, key)
    pair (dv, dp, dq, dk: twice the forward's) at the dtype's peak. The
    recomputed S is not needed, so it is not counted."""
    es = 4 if dtype == "float32" else 2
    n_bytes = es * b * s * d * (4 * h + 4 * hkv) + 4 * b * h * s
    flops = 8 * b * h * d * s * (s + 1) // 2
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), \
        n_bytes, flops


def _grad_agrees(torch, got, want, dtype: str, what: str) -> float:
    """Holds a gradient against its reference: max abs error within
    atol + rtol |want| and, where the gradient is above rounding, the
    error's norm over the reference's; returns the max absolute error."""
    rtol, atol, rel_tol = BWD_TOLERANCE[dtype]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    ok = bool((diff <= atol + rtol * w.abs()).all()) and math.isfinite(err)
    w_norm = torch.linalg.vector_norm(w).item()
    rel = torch.linalg.vector_norm(g - w).item() / w_norm if w_norm else 0.0
    gated = w_norm > RMS_FLOOR * w.numel() ** 0.5
    ok = ok and (not gated or rel <= rel_tol)
    log(f"attn-bwd: {what} {dtype}: max_abs_err={err:.3e} (atol {atol} + rtol {rtol}) "
        f"rel_norm_err={rel:.3e} tol={rel_tol}{'' if gated else ' (below rounding: not gated)'} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"attention backward: {what} {dtype} disagree: max_abs_err {err}, "
              f"rel_norm_err {rel}")
    return err


def phase_attn_bwd(torch, cfg) -> dict:
    """The attention's backward kernel against the plain backward on the
    card at qwen3-0.6b's widths, and the forward's lse against the plain
    lse; then the backward's times, the plain backward's, SDPA's backward
    as a yardstick, the bound, two calls bit-equal (no atomics), and the
    forward with its lse against without, against the plain forward with
    its lse and against SDPA's forward where grad is on (it keeps its
    logsumexp); the float32 route timed the same way at BWD_TIMED_F32.
    Inputs are randn, the incoming gradient too."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gen = torch.Generator(device="cuda").manual_seed(8765)

    def inputs(b, s, dtype):
        dt = getattr(torch, dtype)
        return tuple(torch.randn((b, s, n, d), generator=gen, device="cuda").to(dt)
                     for n in (h, hkv, hkv, h))

    routes = {}
    for dtype in ("float32", "bfloat16"):
        routes[dtype] = FA.bwd_route_info(getattr(torch, dtype))
        for name, info in routes[dtype].items():
            log(f"attn-bwd: {dtype} {name} kernel ({info['design']}): {info['registers']} "
                f"registers and {info['local_bytes']} local (spill) bytes a thread, shared "
                f"memory {info['static_smem']} B static + {info['dynamic_smem']} B dynamic a "
                f"block, {info['threads']} threads a block, {info['blocks_per_sm']} blocks "
                f"resident on an SM")
            check(info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1,
                  f"attn-bwd: {dtype} {name} kernel spills or does not fit an SM")

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    lse_err = {"float32": 0.0, "bfloat16": 0.0}
    checks = [(b, s, dtype) for b, s in BWD_SHAPES for dtype in ("float32", "bfloat16")]
    checks += [(1, s, dtype) for s in BWD_DIAGONAL_S for dtype in ("float32", "bfloat16")]
    for b, s, dtype in checks:
        q, k, v, dout = inputs(b, s, dtype)
        out, lse = FA._launch(q, k, v, with_lse=True)
        want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v)
        e = (lse - want_lse).abs().max().item()
        check(e <= LSE_TOLERANCE[dtype], f"attn-bwd: forward lse B={b} S={s} {dtype}: "
                                         f"max_abs_err {e} > {LSE_TOLERANCE[dtype]}")
        lse_err[dtype] = max(lse_err[dtype], e)
        _attn_agrees(torch, out, want_out, dtype, f"forward with lse vs plain B={b} S={s}")
        got = FA._launch_bwd(q, k, v, out, lse, dout)
        want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            max_err[dtype] = max(max_err[dtype], _grad_agrees(
                torch, g, w, dtype, f"{name} kernel vs plain B={b} S={s} H={h} Hkv={hkv} "
                                    f"d={d}"))
        del q, k, v, dout, out, lse, got, want
    log(f"attn-bwd: forward lse vs plain lse: max_abs_err float32 {lse_err['float32']:.3e} "
        f"(tol {LSE_TOLERANCE['float32']}), bfloat16 {lse_err['bfloat16']:.3e} "
        f"(tol {LSE_TOLERANCE['bfloat16']}) ok")
    torch.cuda.empty_cache()

    timings = {}
    for b, s in BWD_TIMED:
        dtype = "bfloat16"
        q, k, v, dout = inputs(b, s, dtype)
        out, lse = FA._launch(q, k, v, with_lse=True)
        # the forward with its lse at the training path's shape, before the
        # backward comparison takes out and lse as given
        want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v)
        e = (lse - want_lse).abs().max().item()
        check(e <= LSE_TOLERANCE[dtype], f"attn-bwd: forward lse B={b} S={s} {dtype}: "
                                         f"max_abs_err {e} > {LSE_TOLERANCE[dtype]}")
        lse_err[dtype] = max(lse_err[dtype], e)
        log(f"attn-bwd: forward lse vs plain lse B={b} S={s} {dtype}: max_abs_err {e:.3e} "
            f"(tol {LSE_TOLERANCE[dtype]}) ok")
        _attn_agrees(torch, out, want_out, dtype, f"forward with lse vs plain B={b} S={s}")
        del want_out, want_lse
        # the yardstick: SDPA's backward in (B, H, S, d) layouts made once
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dout_t = dout.transpose(1, 2).contiguous()

        def library():
            return torch.autograd.grad(lib_out, (qt, kt, vt), dout_t, retain_graph=True)

        fns = {"kernel": lambda: FA._launch_bwd(q, k, v, out, lse, dout),
               "plain": lambda: FA.flash_attention_bwd_plain(q, k, v, out, lse, dout),
               "library": library}
        got = fns["kernel"]()
        err = max(_grad_agrees(torch, g, w, dtype, f"{name} kernel vs plain B={b} S={s}")
                  for name, g, w in zip(("dq", "dk", "dv"), got,
                                        fns["plain"]()))
        max_err[dtype] = max(max_err[dtype], err)
        lib = library()
        lib_err = max(_grad_agrees(torch, a.transpose(1, 2), g, dtype,
                                   f"{name} SDPA backward vs kernel B={b} S={s}")
                      for name, a, g in zip(("dq", "dk", "dv"), lib, got))
        again = fns["kernel"]()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"attn-bwd: two backward calls at B={b} S={s} differ")
        log(f"attn-bwd: B={b} S={s} {dtype}: two backward calls bit-equal (dq, dk, dv)")
        del got, lib, again
        t = _time_alternating(torch, fns, iters=3, rounds=3)
        # the forward with and without its lse, in turns, as attn-kernel
        # times it, with the plain forward with lse and SDPA's forward with
        # grad on (which keeps its logsumexp for the backward)
        t.update(_time_alternating(torch, {
            "fwd_lse": lambda: FA._launch(q, k, v, with_lse=True),
            "fwd": lambda: FA._launch(q, k, v),
            "fwd_lse_plain": lambda: FA.flash_attention_fwd_plain(q, k, v),
            "fwd_lse_library": lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)}, iters=20))
        dev_ms = _queued_ms(torch, fns["kernel"], 10)
        lib_dev_ms = _queued_ms(torch, library, 10)
        # the three kernels of a call: the statistics pass, dk/dv, dq
        split = _profiled_split_ms(
            torch, fns["kernel"], ("flash_bwd_stats", "flash_bwd_dkdv", "flash_bwd_dq"), 3)
        bound_ms, bound_by, n_bytes, flops = attention_bwd_bound(b, s, h, hkv, d, dtype)
        timings[(b, s)] = dict(t, bound_ms=bound_ms, bound_by=bound_by, device_ms=dev_ms,
                               library_device_ms=lib_dev_ms, device_split=split)
        log(f"attn-bwd: B={b} S={s} {dtype} kernel_ms={t['kernel']:.5f} "
            f"kernel_device_ms={dev_ms:.5f} "
            f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} "
            f"library_device_ms={lib_dev_ms:.5f} (SDPA causal GQA "
            f"backward, max_abs_err vs kernel {lib_err:.3e}) bound_ms={bound_ms:.5f} "
            f"({bound_by}: {flops / 1e12:.4f} TFLOP at {PEAK_FLOPS[dtype] / 1e12:.0f} "
            f"TFLOP/s, {n_bytes / 1e6:.3f} MB at 3.35 TB/s) "
            f"share_of_bound={bound_ms / t['kernel']:.4f} "
            f"achieved_tflops={flops / t['kernel'] / 1e9:.3f}")
        log(f"attn-bwd: B={b} S={s} {dtype} device ms by kernel (profiler): " + (
            ", ".join(f"{name[len('flash_bwd_'):]} {ms:.5f}" for name, ms in split.items())
            if split else f"not measured (each of {PROFILE_ATTEMPTS} sessions lost "
                          f"kernel records)"))
        log(f"attn-bwd: forward B={b} S={s} {dtype} with lse {t['fwd_lse']:.5f} ms, "
            f"without {t['fwd']:.5f} ms (ratio {t['fwd_lse'] / t['fwd']:.4f}); plain "
            f"forward with lse {t['fwd_lse_plain']:.5f} ms; SDPA forward with grad on "
            f"{t['fwd_lse_library']:.5f} ms")
        del q, k, v, dout, out, lse, qt, kt, vt, lib_out, dout_t, fns
        torch.cuda.empty_cache()

    # the float32 route (CUDA cores), timed as above
    b, s = BWD_TIMED_F32
    dtype = "float32"
    q, k, v, dout = inputs(b, s, dtype)
    out, lse = FA._launch(q, k, v, with_lse=True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dout_t = dout.transpose(1, 2).contiguous()
    fns = {"kernel": lambda: FA._launch_bwd(q, k, v, out, lse, dout),
           "plain": lambda: FA.flash_attention_bwd_plain(q, k, v, out, lse, dout),
           "library": lambda: torch.autograd.grad(lib_out, (qt, kt, vt), dout_t,
                                                  retain_graph=True)}
    got = fns["kernel"]()
    max_err[dtype] = max(max_err[dtype], max(
        _grad_agrees(torch, g, w, dtype, f"{name} kernel vs plain B={b} S={s}")
        for name, g, w in zip(("dq", "dk", "dv"), got, fns["plain"]())))
    del got
    t = _time_alternating(torch, fns, iters=2, rounds=3)
    bound_ms, bound_by, n_bytes, flops = attention_bwd_bound(b, s, h, hkv, d, dtype)
    timings[(b, s, dtype)] = dict(t, bound_ms=bound_ms, bound_by=bound_by)
    log(f"attn-bwd: B={b} S={s} {dtype} kernel_ms={t['kernel']:.5f} plain_ms="
        f"{t['plain']:.5f} library_ms={t['library']:.5f} (SDPA causal GQA backward, "
        f"float32) bound_ms={bound_ms:.5f} ({bound_by}: {flops / 1e12:.4f} TFLOP at "
        f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, {n_bytes / 1e6:.3f} MB at 3.35 TB/s) "
        f"share_of_bound={bound_ms / t['kernel']:.4f} "
        f"achieved_tflops={flops / t['kernel'] / 1e9:.3f}")
    del q, k, v, dout, out, lse, qt, kt, vt, lib_out, dout_t, fns
    torch.cuda.empty_cache()
    return {"max_err": max_err, "lse_err": lse_err, "timings": timings, "routes": routes}


# ---------------------------------------------------------------- lm-train --

def phase_lm_train(torch, cfg, seed: int) -> dict:
    """qwen3-0.6b's training path on the card. (a) float32 at full width cut
    to TRAIN_CHECK_LAYERS layers: the loss and the gradient of every leaf
    through the kernels ("flash": the forward kernel with its lse, the
    backward kernel) against plain torch autograd ("chunked"), every leaf's
    gradient nonzero. (b) The full-width bfloat16 model from the training
    launcher's ``build(..., full=True)`` trained TRAIN_STEPS steps of
    TRAIN_B x TRAIN_S through ``Trainer`` + ``adamw`` (the launcher's
    schedule); both attention counters are set to 0 just before and read
    just after, and must show 28 forward and 28 backward launches a step;
    the loss falls; step ms, tokens/s, peak memory, busy share and the
    attention's share of a step's device time. (c) ``python -m
    repro_torch.launch.train`` at full width on the card, exiting 0."""
    import dataclasses
    import functools

    from repro_torch.core.treepath import tree_leaves, tree_map
    from repro_torch.data import lm as lm_data
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as tfm
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer

    # (a) float32 gradients: kernels against plain autograd
    cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=TRAIN_CHECK_LAYERS)
    params = tfm.init_lm(cfg32, torch.Generator("cuda").manual_seed(seed), "cuda")
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(lm_data.token_batches(
        cfg.vocab_size, TRAIN_CHECK_B, TRAIN_CHECK_S, seed=seed)).items()}
    results = {}
    for impl in ("flash", "chunked"):
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        before = (FA.launches, FA.bwd_launches)
        loss, _ = tfm.loss_fn(live, batch, dataclasses.replace(cfg32, attn_impl=impl))
        grads = torch.autograd.grad(loss, tree_leaves(live))
        results[impl] = (loss.item(), grads, (FA.launches - before[0],
                                              FA.bwd_launches - before[1]))
    check(results["flash"][2] == (TRAIN_CHECK_LAYERS, TRAIN_CHECK_LAYERS)
          and results["chunked"][2] == (0, 0),
          f"lm-train: float32 check launched {results['flash'][2]} (flash), "
          f"{results['chunked'][2]} (chunked)")
    loss_rel = abs(results["flash"][0] - results["chunked"][0]) / abs(results["chunked"][0])
    worst, zero = 0.0, 0
    for g, w in zip(results["flash"][1], results["chunked"][1]):
        worst = max(worst, (torch.linalg.vector_norm(g - w)
                            / torch.linalg.vector_norm(w)).item())
        zero += int(not bool(g.abs().max() > 0))
    n_leaves = len(results["flash"][1])
    ok = loss_rel <= TRAIN_GRAD_REL and worst <= TRAIN_GRAD_REL and zero == 0
    log(f"lm-train: float32 {cfg.name} at full width cut to {TRAIN_CHECK_LAYERS} layers, "
        f"B={TRAIN_CHECK_B} S={TRAIN_CHECK_S}: loss flash (kernels) {results['flash'][0]:.6f} "
        f"vs chunked (plain autograd) {results['chunked'][0]:.6f} (rel {loss_rel:.3e}); "
        f"{n_leaves} gradient leaves, worst error norm over gradient norm {worst:.3e} "
        f"(tol {TRAIN_GRAD_REL}), {zero} all-zero; launches fwd/bwd "
        f"{results['flash'][2]} {'ok' if ok else 'FAIL'}")
    check(ok, f"lm-train: float32 gradients through the kernels disagree with plain "
              f"autograd: loss rel {loss_rel}, worst leaf {worst}, {zero} zero leaves")
    del params, results, live, grads, loss
    torch.cuda.empty_cache()

    # (b) full width, bfloat16, through the launcher's build and Trainer
    t0 = time.perf_counter()
    tcfg, params, loss_fn, data = launch_train.build(cfg.name, True, TRAIN_B, TRAIN_S,
                                                     "cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    tr = Trainer(loss_fn, adamw(warmup_cosine_schedule(TRAIN_LR, 10, TRAIN_STEPS)), params)
    del params
    torch.cuda.synchronize()
    log(f"lm-train: {tcfg.name} {tcfg.dtype} params={n_params:,} from "
        f"launch.train.build(full=True) on the card in {time.perf_counter() - t0:.3f} s; "
        f"B={TRAIN_B} S={TRAIN_S} ({TRAIN_B * TRAIN_S} tokens a step), Trainer + "
        f"adamw(warmup_cosine_schedule({TRAIN_LR}, 10, {TRAIN_STEPS}))")
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted ----
    FA.reset_launches()
    FA.reset_bwd_launches()
    t0 = time.perf_counter()
    tr.run(data, max_steps=TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = FA.launches, FA.bwd_launches
    # ---- end of the counted run ----
    peak = torch.cuda.max_memory_allocated()
    losses = [hh["loss"] for hh in tr.history]
    step_ms = [hh["step_time_s"] * 1e3 for hh in tr.history]
    check(all(math.isfinite(x) for x in losses), "lm-train: a loss is not finite")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    med = statistics.median(step_ms[1:])
    log(f"lm-train: {TRAIN_STEPS} steps in {train_s:.3f} s; step_ms first={step_ms[0]:.3f} "
        f"median(2..{TRAIN_STEPS})={med:.3f} min={min(step_ms[1:]):.3f} "
        f"max={max(step_ms[1:]):.3f}; {TRAIN_B * TRAIN_S / med * 1e3:.1f} tokens/s; loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; peak allocated {peak / 1e9:.3f} GB")
    log(f"lm-train: flash_attention launches={fwd}, flash_attention_bwd launches={bwd} "
        f"over {TRAIN_STEPS} steps ({cfg.n_layers} layers)")
    check(fwd > 0 and bwd > 0, "lm-train: the training path launched an attention kernel "
                               "no time")
    check(fwd == bwd == cfg.n_layers * TRAIN_STEPS,
          f"lm-train: expected {cfg.n_layers} forward and backward launches a step, got "
          f"{fwd} and {bwd} over {TRAIN_STEPS} steps")
    check(last < first, f"lm-train: the loss did not fall ({first:.4f} -> {last:.4f})")
    step_bound_ops = (6 * n_params * TRAIN_B * TRAIN_S
                      + 3 * cfg.n_layers * 4 * TRAIN_B * cfg.n_heads * cfg.d_head
                      * TRAIN_S * (TRAIN_S + 1) // 2)
    step_bound_ms = step_bound_ops / PEAK_FLOPS["bfloat16"] * 1e3
    log(f"lm-train: step bound {step_bound_ops:.4e} operations (6 N T + attention at 3x "
        f"its forward) = {step_bound_ms:.3f} ms at 989 TFLOP/s; share of bound "
        f"{step_bound_ms / med:.4f}")
    busy = _busy_share(torch, lambda: tr.run(data, max_steps=tr.step + 1, log_every=0),
                       "flash", top=8)
    log(f"lm-train: one step B={TRAIN_B} S={TRAIN_S} {busy}")
    del tr, data
    torch.cuda.empty_cache()

    # (c) the launcher itself, at full width on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI],
                          env=env, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=600)
    cli_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"lm-train: python -m repro_torch.launch.train {' '.join(TRAIN_CLI)}: exit "
        f"{proc.returncode} in {cli_s:.3f} s: {' | '.join(lines[-3:])}")
    check(proc.returncode == 0 and lines and lines[-1].startswith("final:")
          and lines[0].startswith(f"arch={cfg.name} family=lm params={n_params:,}"),
          f"lm-train: the launcher failed: {proc.stderr[-2000:]}")
    return {"launches": fwd, "bwd_launches": bwd, "step_ms": med, "peak": peak,
            "loss": (first, last), "bound_ms": step_bound_ms}


# -------------------------------------------------------------- bag-kernel --

def bag_bound(ids, weighted: bool, d: int, dtype: str):
    """Least time for the bag sum on the card, from this call's ids: the
    ids (and weights) read once, each distinct row they name read once, the
    (B, d) output written once, at the memory rate, against the d adds (and
    d multiplies, weighted) of each named row at the float32 peak."""
    es = 4 if dtype == "float32" else 2
    b, l = ids.shape
    distinct = int(ids.unique().numel())
    n_bytes = ids.numel() * (4 + (4 if weighted else 0)) + (distinct + b) * d * es
    flops = b * l * d * (2 if weighted else 1)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), \
        n_bytes, distinct


def _bag_agrees(torch, EB, table, ids, weights, dtype: str, what: str) -> float:
    """The kernel against its plain version on the same inputs, by max
    absolute error at the dtype's tolerance; returns the error."""
    got = EB.embedding_bag(table, ids, weights)
    want = EB.embedding_bag_plain(table, ids, weights)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    exact = bool(torch.equal(got, want))
    ok = math.isfinite(err) and err <= BAG_TOLERANCE[dtype]
    log(f"bag-kernel: {what} {dtype}: max_abs_err={err:.3e} tol={BAG_TOLERANCE[dtype]} "
        f"bit_equal={exact} {'ok' if ok else 'FAIL'}")
    check(ok, f"bag kernel disagrees with its plain version at {what} {dtype}: {err}")
    # both sum each bag in float32 in order, each product and sum rounded
    # on its own, so they agree bit for bit (a bag of one row is that row)
    check(exact, f"bag kernel is not bit-equal to its plain version at {what} {dtype}")
    return err


def _top_ids(torch, gen, v: int, shape):
    """int32 ids drawn from the last BAG_TOP of a table's v rows."""
    return torch.randint(int(v * (1 - BAG_TOP)), v, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


def _serve_ids(torch, cfg, batch: int, seed: int):
    """A serve batch's ids from data/recsys.py with the field offsets folded
    in, as embedding_lookup hands them to the kernel: (batch * 26, 1)."""
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec
    ids = torch.from_numpy(rec_data.batch_for(cfg, batch, seed=seed)["ids"]).cuda()
    return (ids + rec.field_offsets(cfg.vocab_sizes, "cuda")).reshape(-1, 1)


def phase_bag_kernel(torch, cfg, seed: int) -> dict:
    """The bag kernel against its plain version, then dlrm-mlperf's table
    drawn at full width, the kernel over it at the path's shapes, and the
    times there. Returns the DLRM parameters for the recsys phases."""
    import torch.nn.functional as F
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec

    gen = torch.Generator(device="cuda").manual_seed(2468)
    sizes = {s.name: s for s in RECSYS_SHAPES}
    p99, bulk = sizes["serve_p99"].batch, sizes["serve_bulk"].batch
    mb, ml = BAG_MULTI
    d = cfg.embed_dim
    max_err = {"float32": 0.0, "bfloat16": 0.0}

    def weights(b, l):
        return torch.rand((b, l), generator=gen, device="cuda")

    for v, d_, b, l in BAG_SHAPES:
        for dtype in ("float32", "bfloat16"):
            table = torch.randn((v, d_), generator=gen, device="cuda").to(getattr(torch, dtype))
            ids = torch.randint(0, v, (b, l), generator=gen, device="cuda", dtype=torch.int32)
            for w in (None, weights(b, l)):
                err = _bag_agrees(torch, EB, table, ids, w, dtype,
                                  f"V={v} d={d_} B={b} L={l} weighted={w is not None}")
                max_err[dtype] = max(max_err[dtype], err)

    # ids outside the table, as jnp.take reads them: [-V, 0) wraps to
    # id + V, and an id outside [-V, V) makes its whole bag NaN
    v, b, l = BAG_SHAPES[3][0], 13, 3
    for dtype in ("float32", "bfloat16"):
        table = torch.randn((v, d), generator=gen, device="cuda").to(getattr(torch, dtype))
        for bad in (-1, -v, v, -v - 1):
            ids = torch.randint(0, v, (b, l), generator=gen, device="cuda", dtype=torch.int32)
            ids[1, 2] = ids[4, 0] = bad
            for w in (None, weights(b, l)):
                got = EB.embedding_bag(table, ids, w).float()
                want = EB.embedding_bag_plain(table, ids, w).float()
                nan_got, nan_want = torch.isnan(got), torch.isnan(want)
                same_nan = bool(torch.equal(nan_got, nan_want))
                nan_bags = nan_want.all(dim=1).nonzero().view(-1).tolist()
                err = (got - want).nan_to_num(0.0).abs().max().item()
                ok = (same_nan and nan_bags == ([1, 4] if bad in (v, -v - 1) else [])
                      and err <= BAG_TOLERANCE[dtype])
                log(f"bag-kernel: id {bad} at bags 1 and 4, V={v} B={b} L={l} "
                    f"weighted={w is not None} {dtype}: NaN positions equal={same_nan}, "
                    f"NaN bags {nan_bags}, max_abs_err elsewhere={err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
                check(ok, f"bag kernel: id {bad} outside the table disagrees with the "
                          f"plain version ({dtype}, weighted={w is not None})")

    # float32 over a table past 2^31 elements: a 32-bit offset would wrap
    table = torch.empty((BAG_F32_ROWS, d), device="cuda").normal_(generator=gen)
    for name, n_bags in (("serve_p99", p99 * cfg.n_sparse), ("serve_bulk", bulk * cfg.n_sparse)):
        err = _bag_agrees(torch, EB, table, _top_ids(torch, gen, BAG_F32_ROWS, (n_bags, 1)),
                          None, "float32", f"{name} {n_bags} bags L=1 V={BAG_F32_ROWS} "
                          f"ids in the last {BAG_TOP:.0%} of rows")
        max_err["float32"] = max(max_err["float32"], err)
    ids = torch.randint(0, BAG_F32_ROWS, (mb, ml), generator=gen, device="cuda",
                        dtype=torch.int32)
    for w in (None, weights(mb, ml)):
        err = _bag_agrees(torch, EB, table, ids, w, "float32",
                          f"multi-hot B={mb} L={ml} V={BAG_F32_ROWS} weighted={w is not None}")
        max_err["float32"] = max(max_err["float32"], err)
    del table, ids
    torch.cuda.empty_cache()

    # dlrm-mlperf's table at full width, drawn on the card from --seed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = rec.init_model(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    table = params["emb"]
    v = table.shape[0]
    # every chunk of the in-place draw holds N(0, 0.02) values: a chunk
    # left undrawn would hold whatever the allocator's memory held
    stds = [table[i:i + rec.INIT_CHUNK_ROWS:509].float().std().item()
            for i in range(0, v, rec.INIT_CHUNK_ROWS)]
    log(f"bag-kernel: dlrm-mlperf parameters drawn on the card in {init_s:.3f} s: table "
        f"{v} x {d} {table.dtype} ({table.numel() * table.element_size() / 1e9:.3f} GB), "
        f"memory allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB; std of every "
        f"{rec.INIT_CHUNK_ROWS}-row chunk (every 509th row) {min(stds):.5f}..{max(stds):.5f}")
    check(all(abs(x - 0.02) < 5e-4 for x in stds),
          f"the table's chunks are not N(0, 0.02): stds {min(stds)}..{max(stds)}")
    serve = {"serve_p99": _serve_ids(torch, cfg, p99, seed),
             "serve_bulk": _serve_ids(torch, cfg, bulk, seed + 1)}
    for name, ids in serve.items():
        for what, ids_ in (("ids from data/recsys.py", ids),
                           (f"ids in the last {BAG_TOP:.0%} of rows",
                            _top_ids(torch, gen, v, tuple(ids.shape)))):
            err = _bag_agrees(torch, EB, table, ids_, None, "bfloat16",
                              f"{name} {ids.shape[0]} bags L=1 V={v} {what}")
            max_err["bfloat16"] = max(max_err["bfloat16"], err)
    multi = torch.randint(0, v, (mb, ml), generator=gen, device="cuda", dtype=torch.int32)
    for w in (None, weights(mb, ml)):
        err = _bag_agrees(torch, EB, table, multi, w, "bfloat16",
                          f"multi-hot B={mb} L={ml} V={v} weighted={w is not None}")
        max_err["bfloat16"] = max(max_err["bfloat16"], err)

    # times over the full table: serve_p99 cycles through BAG_P99_SETS id
    # sets so each launch finds its rows cold in L2, as a stream of
    # requests would
    sets = {"serve_p99": [serve["serve_p99"]]
            + [_serve_ids(torch, cfg, p99, seed + 100 + i) for i in range(BAG_P99_SETS - 1)],
            "serve_bulk": [serve["serve_bulk"]], "multi-hot": [multi]}
    timings = {}
    for name, id_sets in sets.items():
        turn = dict.fromkeys(("kernel", "plain", "library", "gather"), 0)

        def cycled(key, fn, id_sets=id_sets, turn=turn):
            def call():
                turn[key] = (turn[key] + 1) % len(id_sets)
                return fn(id_sets[turn[key]])
            return call

        fns = {"kernel": cycled("kernel", lambda i: EB.embedding_bag(table, i)),
               "plain": cycled("plain", lambda i: EB.embedding_bag_plain(table, i)),
               "library": cycled("library", lambda i: F.embedding_bag(i, table, mode="sum"))}
        if id_sets[0].shape[1] == 1:   # a plain row gather, for scale (not the function)
            fns["gather"] = cycled("gather", lambda i: table.index_select(0, i.view(-1)))
        lib_err = (F.embedding_bag(id_sets[0], table, mode="sum").float()
                   - EB.embedding_bag_plain(table, id_sets[0]).float()).abs().max().item()
        check(lib_err <= BAG_TOLERANCE["bfloat16"],
              f"F.embedding_bag disagrees with the plain version at {name}: {lib_err}")
        iters = 200 if name == "serve_p99" else 20
        t = _time_alternating(torch, fns, iters=iters)
        dev_ms = _queued_ms(torch, fns["kernel"], iters)
        bounds = [bag_bound(i, False, d, "bfloat16") for i in id_sets]
        bound_ms = statistics.mean(b[0] for b in bounds)
        n_bytes = statistics.mean(b[2] for b in bounds)
        distinct = statistics.mean(b[3] for b in bounds)
        b, l = id_sets[0].shape
        rows_ms = (b * l * 4 + (b * l + b) * d * 2) / HBM_BYTES_PER_S * 1e3
        timings[name] = dict(t, bound_ms=bound_ms, bound_by=bounds[0][1], device_ms=dev_ms,
                             shape=f"B={b} L={l} d={d} V={v}")
        log(f"bag-kernel: {name} B={b} L={l} bfloat16 kernel_ms={t['kernel']:.5f} "
            f"kernel_device_ms={dev_ms:.5f} "
            f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} (F.embedding_bag "
            f"mode=sum, max_abs_err vs plain {lib_err:.2e}) "
            + (f"gather_ms={t['gather']:.5f} (index_select of the rows) " if "gather" in t else "")
            + f"bound_ms={bound_ms:.5f} "
            f"({bounds[0][1]}: {n_bytes / 1e6:.3f} MB at 3.35 TB/s, {distinct:.0f} distinct "
            f"rows of {b * l} named; every named row once: {rows_ms:.5f} ms) "
            f"share_of_bound={bound_ms / t['kernel']:.4f} "
            f"achieved_GB/s={n_bytes / t['kernel'] / 1e6:.1f}")
    del serve, sets, multi
    torch.cuda.empty_cache()
    return {"max_err": max_err, "timings": timings, "params": params, "init_s": init_s}


# --------------------------------------------------------------- rec-check --

def _rec_batch(torch, batch: dict) -> dict:
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items() if k != "label"}


def phase_rec_check(torch, cfg, params, seed: int) -> None:
    """The DLRM path in bfloat16 through the kernel against the same path
    through the plain version (reduced(dlrm-mlperf) in float32 on the card
    against the CPU is rec-train's, with its loss and gradients)."""
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec

    for b in REC_CHECK_BATCHES:
        batch = _rec_batch(torch, rec_data.batch_for(cfg, b, seed=seed + 7 + b))
        got = rec.serve_step(params, batch, cfg)
        want = rec.serve_step(params, batch, cfg, lookup="plain")
        ok = (tuple(got.shape) == (b,) and bool(torch.isfinite(got).all())
              and bool(torch.equal(got, want)))
        log(f"rec-check: serve_step B={b} bfloat16 kernel == plain lookup: "
            f"{'ok' if ok else 'FAIL'} (max_abs_err "
            f"{(got - want).abs().max().item():.3e}, scores std {got.std().item():.4f})")
        check(ok, f"serve_step through the kernel != through the plain lookup at B={b}")
    batch = _rec_batch(torch, rec_data.retrieval_batch(cfg, REC_CHECK_CANDIDATES, seed=seed + 9))
    got = rec.retrieval_step(params, batch, cfg)
    want = rec.retrieval_step(params, batch, cfg, lookup="plain")
    ok = (tuple(got.shape) == (REC_CHECK_CANDIDATES,) and bool(torch.isfinite(got).all())
          and bool(torch.equal(got, want)))
    log(f"rec-check: retrieval_step N={REC_CHECK_CANDIDATES} bfloat16 kernel == plain "
        f"lookup: {'ok' if ok else 'FAIL'} (max_abs_err {(got - want).abs().max().item():.3e})")
    check(ok, "retrieval_step through the kernel != through the plain lookup")


# --------------------------------------------------------------------- rec --

def phase_rec(torch, cfg, params, seed: int) -> dict:
    """dlrm-mlperf's serving path at full width in bfloat16. The bag
    kernel's launch count is set to 0 just before and read just after, and
    must be 1 per serve_step and 2 per retrieval_step."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.data import recsys as rec_data
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec

    sync = torch.cuda.synchronize
    sizes = {s.name: s for s in RECSYS_SHAPES}
    p99, bulk = sizes["serve_p99"].batch, sizes["serve_bulk"].batch
    n_cand = sizes["retrieval_cand"].n_candidates
    t0 = time.perf_counter()
    gen = rec_data.batches(cfg, p99, seed=seed)
    p99_batches = [_rec_batch(torch, next(gen)) for _ in range(REC_P99_STEPS + 1)]
    bulk_batch = _rec_batch(torch, rec_data.batch_for(cfg, bulk, seed=seed + 1))
    ret_batch = _rec_batch(torch, rec_data.retrieval_batch(cfg, n_cand, seed=seed + 2))
    sync()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"rec: cfg={cfg.name} fields={cfg.n_sparse} embed_dim={cfg.embed_dim} "
        f"bot={cfg.bot_mlp} top={cfg.top_mlp} {cfg.dtype} params={n_params} "
        f"(n_params() {cfg.n_params()}; the table padded to {params['emb'].shape[0]} rows); "
        f"batches made in {time.perf_counter() - t0:.3f} s")
    # warm-up at each shape: allocator, cuBLAS handles and heuristics
    rec.serve_step(params, p99_batches[-1], cfg)
    rec.serve_step(params, bulk_batch, cfg)
    rec.retrieval_step(params, ret_batch, cfg)
    sync()
    torch.cuda.empty_cache()

    # ---- the main path, counted ----
    EB.reset_launches()
    peak = {}
    torch.cuda.reset_peak_memory_stats()
    p99_s = []
    for batch in p99_batches[:REC_P99_STEPS]:
        t = time.perf_counter()
        scores = rec.serve_step(params, batch, cfg)
        sync()
        p99_s.append(time.perf_counter() - t)
        check(tuple(scores.shape) == (p99,) and bool(torch.isfinite(scores).all()),
              "serve_p99 scores not finite (B,)")
    peak["serve_p99"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bulk_s = []
    for _ in range(REC_BULK_STEPS):
        t = time.perf_counter()
        scores = rec.serve_step(params, bulk_batch, cfg)
        sync()
        bulk_s.append(time.perf_counter() - t)
    check(tuple(scores.shape) == (bulk,) and bool(torch.isfinite(scores).all()),
          "serve_bulk scores not finite (B,)")
    bulk_std = scores.std().item()
    del scores
    peak["serve_bulk"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ret_s = []
    for _ in range(REC_RETRIEVAL_STEPS):
        t = time.perf_counter()
        cand = rec.retrieval_step(params, ret_batch, cfg)
        sync()
        ret_s.append(time.perf_counter() - t)
    peak["retrieval_cand"] = torch.cuda.max_memory_allocated()
    launches = EB.launches
    # ---- end of the counted run ----

    check(tuple(cand.shape) == (n_cand,) and bool(torch.isfinite(cand).all()),
          "retrieval scores not finite (N,)")
    n_serve = REC_P99_STEPS + REC_BULK_STEPS
    log(f"rec: serve_p99 B={p99}, {REC_P99_STEPS} steps: p50_ms={_percentile(p99_s, 0.5) * 1e3:.3f} "
        f"p99_ms={_percentile(p99_s, 0.99) * 1e3:.3f} (min {min(p99_s) * 1e3:.3f}, max "
        f"{max(p99_s) * 1e3:.3f}); peak allocated {peak['serve_p99'] / 1e9:.3f} GB")
    med = statistics.median(bulk_s)
    log(f"rec: serve_bulk B={bulk}: {','.join(f'{x * 1e3:.3f}' for x in bulk_s)} ms, median "
        f"{med * 1e3:.3f} ms, {bulk / med:.1f} examples/s; scores std {bulk_std:.4f}; peak "
        f"allocated {peak['serve_bulk'] / 1e9:.3f} GB")
    med_r = statistics.median(ret_s)
    log(f"rec: retrieval_cand 1 query x {n_cand} candidates: "
        f"{','.join(f'{x * 1e3:.3f}' for x in ret_s)} ms, median {med_r * 1e3:.3f} ms, "
        f"{n_cand / med_r:.1f} candidates/s; peak allocated "
        f"{peak['retrieval_cand'] / 1e9:.3f} GB; top candidate {int(cand.argmax())}")
    log(f"rec: embedding_bag launches={launches} over {n_serve} serve_step and "
        f"{REC_RETRIEVAL_STEPS} retrieval_step calls")
    check(launches > 0, "the DLRM path launched the bag kernel no time")
    check(launches == n_serve + 2 * REC_RETRIEVAL_STEPS,
          f"expected 1 bag launch per serve_step and 2 per retrieval_step, got {launches} "
          f"for {n_serve} and {REC_RETRIEVAL_STEPS}")
    del cand
    torch.cuda.empty_cache()
    log(f"rec: serve_bulk B={bulk} "
        f"{_busy_share(torch, lambda: rec.serve_step(params, bulk_batch, cfg), 'embedding_bag', top=12)}")
    return {"launches": launches}


# ----------------------------------------------------------------- bag-bwd --

def bag_bwd_bound(ids, weighted: bool, d: int, v: int, dtype: str):
    """Least time for the table gradient on the card: the ids (and weights)
    read once, grad_out's B rows read once and the dense (V, d) gradient
    written once, at the memory rate, against the d adds (and d multiplies,
    weighted) of each position at the float32 peak."""
    es = 4 if dtype == "float32" else 2
    b, l = ids.shape
    n_bytes = ids.numel() * (4 + (4 if weighted else 0)) + (b + v) * d * es
    flops = b * l * d * (2 if weighted else 1)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), n_bytes


def _bwd_agrees(torch, EB, g, ids, w, v: int, what: str) -> float:
    """The backward kernel against its plain version on the same inputs, bit
    for bit (both sum in the kernel's order); returns the max abs error."""
    got = EB.embedding_bag_bwd(g, ids, w, v)
    want = EB.embedding_bag_bwd_plain(g, ids, w, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    exact = bool(torch.equal(got, want))
    dtype = str(g.dtype).replace("torch.", "")
    log(f"bag-bwd: {what} weighted={w is not None} {dtype}: max_abs_err={err:.3e} "
        f"bit_equal={exact} {'ok' if exact else 'FAIL'}")
    check(exact, f"bag backward kernel is not bit-equal to its plain version at {what} "
                 f"{dtype} weighted={w is not None}: {err}")
    return err


def phase_bag_bwd(torch, cfg, seed: int) -> dict:
    """The EmbeddingBag backward kernel against its plain version, bit for
    bit, in float32 and bfloat16, weighted and not: at BAG_SHAPES, a 3-row
    field named 65,536 times, ids outside the table, a float32 gradient past
    2^31 elements; then dlrm-mlperf's training lookup (B=65,536 x 26 bags of
    one row over the table cut to REC_TRAIN_MAX_ROWS rows a field): two
    calls bit-equal, times of the kernel, its sort, the plain version and
    embedding_dense_backward (the yardstick), the bound."""
    import dataclasses

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec

    gen = torch.Generator(device="cuda").manual_seed(1357)
    d = cfg.embed_dim
    max_err = {"float32": 0.0, "bfloat16": 0.0}

    def ids_in(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)

    def grad_out(b, d_, dtype):
        return torch.randn((b, d_), generator=gen, device="cuda").to(getattr(torch, dtype))

    cases = [(f"V={v} d={d_} B={b} L={l}", v, d_, ids_in(0, v, (b, l)))
             for v, d_, b, l in BAG_SHAPES]
    hv, hn = BAG_BWD_HOT
    cases.append((f"a {hv}-row field at B={hn} L=1", hv, d, ids_in(0, hv, (hn, 1))))
    v = BAG_SHAPES[3][0]
    for bad in (-1, -v, v, -v - 1):   # [-V, 0) wraps; outside [-V, V) adds nothing
        ids = ids_in(0, v, (13, 3))
        ids[1, 2] = ids[4, 0] = bad
        cases.append((f"id {bad} at bags 1 and 4, V={v} B=13 L=3", v, d, ids))
    for what, v, d_, ids in cases:
        for dtype in ("float32", "bfloat16"):
            g = grad_out(ids.shape[0], d_, dtype)
            for w in (None, torch.rand(tuple(ids.shape), generator=gen, device="cuda")):
                max_err[dtype] = max(max_err[dtype], _bwd_agrees(torch, EB, g, ids, w, v, what))
    # a float32 gradient past 2^31 elements: a 32-bit offset would wrap
    ids = _top_ids(torch, gen, BAG_F32_ROWS, (BAG_MULTI[0], 1))
    g = grad_out(ids.shape[0], d, "float32")
    max_err["float32"] = max(max_err["float32"], _bwd_agrees(
        torch, EB, g, ids, None, BAG_F32_ROWS,
        f"V={BAG_F32_ROWS} d={d} B={ids.shape[0]} L=1, ids in the last {BAG_TOP:.0%} of rows"))
    del ids, g
    torch.cuda.empty_cache()

    # dlrm-mlperf's training lookup, the table cut as rec-train cuts it
    cut = dataclasses.replace(cfg, vocab_sizes=tuple(min(x, REC_TRAIN_MAX_ROWS)
                                                     for x in cfg.vocab_sizes))
    v = rec.padded_rows(sum(cut.vocab_sizes))
    b_train = {s_.name: s_ for s_ in RECSYS_SHAPES}["train_batch"].batch
    ids = _serve_ids(torch, cut, b_train, seed)
    g = grad_out(ids.shape[0], d, "bfloat16")
    counts = torch.bincount(ids.view(-1).long(), minlength=v)
    log(f"bag-bwd: training lookup {ids.shape[0]} bags of one row (B={b_train} x "
        f"{cfg.n_sparse} fields) over V={v} rows (fields cut to {REC_TRAIN_MAX_ROWS}): "
        f"{int((counts > 0).sum())} rows named, the hottest {int(counts.max())} times, "
        f"{int((counts > EB.BWD_CHUNK).sum())} rows named more than {EB.BWD_CHUNK} times")
    first = EB.embedding_bag_bwd(g, ids, None, v)
    second = EB.embedding_bag_bwd(g, ids, None, v)
    torch.cuda.synchronize()
    twice = bool(torch.equal(first, second))
    log(f"bag-bwd: two calls at the training lookup bit-equal: {twice}")
    check(twice, "bag backward: two calls differ")
    max_err["bfloat16"] = max(max_err["bfloat16"], _bwd_agrees(
        torch, EB, g, ids, None, v, f"training lookup V={v} d={d} B={ids.shape[0]} L=1"))
    flat = ids.view(-1).long()
    lib = torch.ops.aten.embedding_dense_backward(g, flat, v, -1, False)
    lib_err = (lib.float() - first.float()).abs().max().item()
    lib_rel = (torch.linalg.vector_norm(lib.float() - first.float())
               / torch.linalg.vector_norm(first.float())).item()
    del first, second, lib
    fns = {"kernel": lambda: EB.embedding_bag_bwd(g, ids, None, v),
           "library": lambda: torch.ops.aten.embedding_dense_backward(g, flat, v, -1, False),
           "sort": lambda: EB._sorted_positions(ids, v)}
    t = _time_alternating(torch, fns, iters=20)
    EB.embedding_bag_bwd_plain(g, ids, None, v)   # warm-up
    plain_ms = _event_ms(torch, lambda: EB.embedding_bag_bwd_plain(g, ids, None, v), 2)
    dev_ms = _queued_ms(torch, fns["kernel"], 20)
    bound_ms, bound_by, n_bytes = bag_bwd_bound(ids, False, d, v, "bfloat16")
    log(f"bag-bwd: training lookup bfloat16 kernel_ms={t['kernel']:.5f} "
        f"kernel_device_ms={dev_ms:.5f} (its torch.sort of the keys {t['sort']:.5f} ms) "
        f"plain_ms={plain_ms:.5f} library_ms={t['library']:.5f} "
        f"(aten.embedding_dense_backward, max_abs_err vs the kernel "
        f"{lib_err:.3e}, error norm {lib_rel:.3e}) bound_ms={bound_ms:.5f} ({bound_by}: "
        f"{n_bytes / 1e6:.3f} MB at 3.35 TB/s: ids, grad_out, the dense gradient) "
        f"share_of_bound={bound_ms / t['kernel']:.4f} device_share={bound_ms / dev_ms:.4f} "
        f"achieved_GB/s={n_bytes / dev_ms / 1e6:.1f}")
    del g, ids, flat, counts
    torch.cuda.empty_cache()
    return {"max_err": max_err,
            "timing": dict(t, plain=plain_ms, device_ms=dev_ms, bound_ms=bound_ms,
                           bound_by=bound_by,
                           shape=f"B={b_train * cfg.n_sparse} L=1 d={d} V={v}")}


# --------------------------------------------------------------- rec-train --

def _grad_trees_close(torch, got, want):
    """(every leaf within REC_GRAD_TOL elementwise, the worst max abs error)."""
    close, worst = True, 0.0
    for g, w in zip(_leaves(got), _leaves(want)):
        g, w = g.float().cpu(), w.float().cpu()
        close &= bool(torch.allclose(g, w, **REC_GRAD_TOL))
        worst = max(worst, (g - w).abs().max().item())
    return close, worst


def _reduced_on_card_vs_cpu(torch, cfg, seed: int, what: str) -> None:
    """reduced(cfg) in float32: serve_step, retrieval_step, loss_fn and every
    gradient leaf on the card against the CPU."""
    import functools

    from repro_torch.configs import reduced
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec
    from repro_torch.training.train_loop import value_and_grad

    small = reduced(cfg)
    cpu = rec.init_model(small, torch.Generator().manual_seed(seed), "cpu")
    card = rec.params_from_numpy(cpu, "cuda")
    batch = rec_data.batch_for(small, 256, seed=seed)
    rbatch = rec_data.retrieval_batch(small, 1000, seed=seed)
    with torch.inference_mode():
        for name, fn, b in (("serve_step B=256", rec.serve_step, batch),
                            ("retrieval_step N=1000", rec.retrieval_step, rbatch)):
            on_card = fn(card, _rec_batch(torch, b), small).cpu()
            on_cpu = fn(cpu, {k: torch.from_numpy(v) for k, v in b.items()}, small)
            err = (on_card - on_cpu).abs().max().item()
            ok = bool(torch.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-5))
            log(f"{what}: {small.name} float32 {name} on the card == on the CPU: "
                f"max_abs_err={err:.3e} (rtol=1e-4 atol=1e-5) {'ok' if ok else 'FAIL'}")
            check(ok, f"{small.name} {name}: the card disagrees with the CPU: {err}")
    loss = functools.partial(rec.loss_fn, cfg=small)
    l_card, _, g_card = value_and_grad(loss, card, {k: torch.from_numpy(v).cuda()
                                                    for k, v in batch.items()})
    l_cpu, _, g_cpu = value_and_grad(loss, cpu, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    loss_rel = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
    close, worst = _grad_trees_close(torch, g_card, g_cpu)
    ok = loss_rel <= REC_LOSS_REL and close
    log(f"{what}: {small.name} float32 loss_fn B=256 on the card {l_card.item():.6f} vs the "
        f"CPU {l_cpu.item():.6f} (rel {loss_rel:.3e}, tol {REC_LOSS_REL}); "
        f"{len(list(_leaves(g_cpu)))} gradient leaves within rtol "
        f"{REC_GRAD_TOL['rtol']} atol {REC_GRAD_TOL['atol']}: {close} (max abs error "
        f"{worst:.3e}) {'ok' if ok else 'FAIL'}")
    check(ok, f"{small.name}: loss or gradients on the card disagree with the CPU: loss rel "
              f"{loss_rel}, worst leaf {worst}")


def phase_rec_train(torch, cfg, seed: int) -> dict:
    """dlrm-mlperf's training path on the card, bfloat16, every width full
    and each field cut to REC_TRAIN_MAX_ROWS rows: Trainer + adamw (the
    launcher's schedule) for REC_TRAIN_STEPS steps of RECSYS_SHAPES'
    train_batch, data from data/recsys.py seed 0; both bag counters set to 0
    just before and read just after: one forward and one backward launch a
    step; the loss falls; step ms, examples/s, peak memory, the step's share
    of its bound, busy share. Then the kernel route's gradient tree ==
    the plain route's (torch.equal, B=REC_TRAIN_CHECK_B), reduced float32 on
    the card against the CPU, and python -m repro_torch.launch.train on the
    card."""
    import dataclasses
    import functools

    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.data import recsys as rec_data
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import recsys as rec
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer, value_and_grad

    cut = dataclasses.replace(cfg, vocab_sizes=tuple(min(v, REC_TRAIN_MAX_ROWS)
                                                     for v in cfg.vocab_sizes))
    b_train = {s_.name: s_ for s_ in RECSYS_SHAPES}["train_batch"].batch
    t0 = time.perf_counter()
    params = rec.init_model(cut, torch.Generator("cuda").manual_seed(seed), "cuda")
    n_params = sum(t_.numel() for t_ in _leaves(params))
    v, d = params["emb"].shape
    loss = functools.partial(rec.loss_fn, cfg=cut)
    tr = Trainer(loss, adamw(warmup_cosine_schedule(REC_TRAIN_LR, 10, REC_TRAIN_STEPS)),
                 params)
    del params
    torch.cuda.synchronize()
    log(f"rec-train: {cfg.name} {cut.dtype} at full width (d={d}, {cut.n_dense} dense, "
        f"{cut.n_sparse} fields, bot {cut.bot_mlp}, top {cut.top_mlp}), fields cut to "
        f"{REC_TRAIN_MAX_ROWS} rows: table {v} x {d} ({v * d * 2 / 1e9:.3f} GB), "
        f"params={n_params:,}, Trainer + adamw(warmup_cosine_schedule({REC_TRAIN_LR}, 10, "
        f"{REC_TRAIN_STEPS})) ready in {time.perf_counter() - t0:.3f} s; "
        f"allocated {torch.cuda.memory_allocated() / 1e9:.3f} GB")
    data = rec_data.batches(cut, b_train, seed=0)
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path, counted ----
    EB.reset_launches()
    EB.reset_bwd_launches()
    t0 = time.perf_counter()
    tr.run(data, max_steps=REC_TRAIN_STEPS, log_every=0)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    fwd, bwd = EB.launches, EB.bwd_launches
    # ---- end of the counted run ----
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.history]
    step_ms = [h["step_time_s"] * 1e3 for h in tr.history]
    check(all(math.isfinite(x) for x in losses), "rec-train: a loss is not finite")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    med = statistics.median(step_ms[1:])
    log(f"rec-train: {REC_TRAIN_STEPS} steps of B={b_train} in {train_s:.3f} s; step_ms "
        f"first={step_ms[0]:.3f} median(2..{REC_TRAIN_STEPS})={med:.3f} "
        f"min={min(step_ms[1:]):.3f} max={max(step_ms[1:]):.3f}; "
        f"{b_train / med * 1e3:.1f} examples/s; loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; peak allocated {peak / 1e9:.3f} GB")
    log(f"rec-train: embedding_bag launches={fwd}, embedding_bag_bwd launches={bwd} over "
        f"{REC_TRAIN_STEPS} steps")
    check(fwd > 0 and bwd > 0, "rec-train: the training path launched a bag kernel no time")
    check(fwd == bwd == REC_TRAIN_STEPS,
          f"rec-train: expected one forward and one backward bag launch a step, got {fwd} "
          f"and {bwd} over {REC_TRAIN_STEPS} steps")
    check(last < first, f"rec-train: the loss did not fall ({first:.4f} -> {last:.4f})")
    # the step's bound: the optimizer's bytes (30 a parameter: the bf16
    # parameter and gradient read, float32 master, mu, nu read and written,
    # the parameter written), both lookups' bytes, against the products
    # (6 B x the MLP weights, 3 x the interaction's 2 B F^2 d) at the bf16 peak
    batch_ids = _serve_ids(torch, cut, b_train, seed + 1)
    fwd_bytes = bag_bound(batch_ids, False, d, cut.dtype)[2]
    bwd_bytes = bag_bwd_bound(batch_ids, False, d, v, cut.dtype)[2]
    del batch_ids
    mlp_w = sum(w.numel() for part in ("bot", "top") for w in tr.params[part]["w"])
    n_f = cut.n_sparse + 1
    ops = 6 * b_train * mlp_w + 3 * 2 * b_train * n_f * n_f * d
    step_bytes = 30 * n_params + fwd_bytes + bwd_bytes
    bound_ms = max(step_bytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS["bfloat16"]) * 1e3
    log(f"rec-train: step bound max(bytes, operations): {30 * n_params / 1e9:.3f} GB of "
        f"optimizer traffic (30 B a parameter) + {fwd_bytes / 1e9:.3f} GB bag forward + "
        f"{bwd_bytes / 1e9:.3f} GB bag backward = {step_bytes / 1e9:.3f} GB, "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s; {ops:.4e} operations "
        f"(6 B x {mlp_w} MLP weights + 3 x the interaction), "
        f"{ops / PEAK_FLOPS['bfloat16'] * 1e3:.3f} ms at 989 TFLOP/s; bound {bound_ms:.3f} "
        f"ms, share of bound {bound_ms / med:.4f}")
    one = [next(data)]   # made before the profiled step: the host's batch is not in it
    busy = _busy_share(torch, lambda: tr.run(iter(one), max_steps=tr.step + 1, log_every=0),
                       "embedding_bag", top=12)
    log(f"rec-train: one step B={b_train} {busy}")

    # the kernel route's gradient tree against the plain route's, bit for bit
    batch = {k: torch.from_numpy(x).cuda()
             for k, x in rec_data.batch_for(cut, REC_TRAIN_CHECK_B, seed=seed + 3).items()}
    trees = {}
    for lookup in ("kernel", "plain"):
        before = (EB.launches, EB.bwd_launches)
        l_, _, g_ = value_and_grad(functools.partial(rec.loss_fn, cfg=cut, lookup=lookup),
                                   tr.params, batch)
        trees[lookup] = (l_.item(), g_, (EB.launches - before[0], EB.bwd_launches - before[1]))
    same = all(bool(torch.equal(a, b)) for a, b in zip(_leaves(trees["kernel"][1]),
                                                      _leaves(trees["plain"][1])))
    ok = (same and trees["kernel"][0] == trees["plain"][0]
          and trees["kernel"][2] == (1, 1) and trees["plain"][2] == (0, 0))
    log(f"rec-train: bfloat16 B={REC_TRAIN_CHECK_B}: loss and {len(list(_leaves(trees['plain'][1])))} "
        f"gradient leaves through the kernels == through the plain route (torch.equal): "
        f"{same}; loss {trees['kernel'][0]:.6f}; launches fwd/bwd kernel route "
        f"{trees['kernel'][2]}, plain route {trees['plain'][2]} {'ok' if ok else 'FAIL'}")
    check(ok, "rec-train: the kernel route's gradient tree differs from the plain route's")
    del trees, tr, data, batch
    torch.cuda.empty_cache()

    _reduced_on_card_vs_cpu(torch, cfg, seed, "rec-train")

    # the launcher itself on the card
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *REC_TRAIN_CLI],
                          env=env, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300)
    lines = proc.stdout.strip().splitlines()
    log(f"rec-train: python -m repro_torch.launch.train {' '.join(REC_TRAIN_CLI)}: exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.3f} s: {' | '.join(lines[-3:])}")
    check(proc.returncode == 0 and lines and lines[-1].startswith("final:")
          and lines[0].startswith(f"arch={cfg.name} family=recsys params="),
          f"rec-train: the launcher failed: {proc.stderr[-2000:]}")
    return {"launches": fwd, "bwd_launches": bwd, "step_ms": med, "peak": peak,
            "loss": (first, last), "bound_ms": bound_ms}


# -------------------------------------------------------------- rec-family --

def _median_ms(torch, fn, n: int) -> float:
    """Median host ms of ``n`` calls, each ended by a synchronize."""
    out = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return statistics.median(out)


def phase_rec_family(torch, seed: int) -> dict:
    """FM and DIN at full width in bfloat16 (weights from --seed, data from
    data/recsys.py): serve_step at serve_p99 and serve_bulk, retrieval_step
    over retrieval_cand's candidates, REC_FAMILY_TRAIN_STEPS Trainer + adamw
    steps at train_batch (finite losses); then reduced float32 on the card
    against the CPU."""
    import functools

    from repro_torch.configs import RECSYS_SHAPES, get_config
    from repro_torch.data import recsys as rec_data
    from repro_torch.models import recsys as rec
    from repro_torch.training.optimizer import adamw, warmup_cosine_schedule
    from repro_torch.training.train_loop import Trainer

    sizes = {s_.name: s_ for s_ in RECSYS_SHAPES}
    p99, bulk = sizes["serve_p99"].batch, sizes["serve_bulk"].batch
    n_cand, b_train = sizes["retrieval_cand"].n_candidates, sizes["train_batch"].batch
    out = {}
    for arch in REC_FAMILY:
        cfg = get_config(arch)
        params = rec.init_model(cfg, torch.Generator("cuda").manual_seed(seed), "cuda")
        n_params = sum(t_.numel() for t_ in _leaves(params))
        res = {}
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            for name, b in (("serve_p99", p99), ("serve_bulk", bulk)):
                batch = _rec_batch(torch, rec_data.batch_for(cfg, b, seed=seed + 1))
                scores = rec.serve_step(params, batch, cfg)   # warm-up
                check(tuple(scores.shape) == (b,) and bool(torch.isfinite(scores).all()),
                      f"rec-family: {arch} {name} scores not finite (B,)")
                res[name] = _median_ms(torch, lambda: rec.serve_step(params, batch, cfg),
                                       REC_FAMILY_P99_STEPS if name == "serve_p99" else 3)
            rb = _rec_batch(torch, rec_data.retrieval_batch(cfg, n_cand, seed=seed + 2))
            cand = rec.retrieval_step(params, rb, cfg)
            check(cand.numel() == n_cand and bool(torch.isfinite(cand).all()),
                  f"rec-family: {arch} retrieval scores not finite ({n_cand})")
            res["retrieval_cand"] = _median_ms(torch, lambda: rec.retrieval_step(params, rb, cfg),
                                               3)
            del batch, scores, rb, cand
        serve_peak = torch.cuda.max_memory_allocated()
        tr = Trainer(functools.partial(rec.loss_fn, cfg=cfg),
                     adamw(warmup_cosine_schedule(REC_TRAIN_LR, 10, REC_FAMILY_TRAIN_STEPS)),
                     params)
        del params
        torch.cuda.reset_peak_memory_stats()
        tr.run(rec_data.batches(cfg, b_train, seed=0), max_steps=REC_FAMILY_TRAIN_STEPS,
               log_every=0)
        torch.cuda.synchronize()
        losses = [h["loss"] for h in tr.history]
        check(all(math.isfinite(x) for x in losses), f"rec-family: {arch} loss not finite")
        res["train_step"] = statistics.median(h["step_time_s"] * 1e3 for h in tr.history[1:])
        log(f"rec-family: {arch} {cfg.dtype} params={n_params:,} (embed_dim {cfg.embed_dim}): "
            f"serve_p99 B={p99} median {res['serve_p99']:.3f} ms, serve_bulk B={bulk} median "
            f"{res['serve_bulk']:.3f} ms ({bulk / res['serve_bulk'] * 1e3:.1f} examples/s), "
            f"retrieval_cand N={n_cand} median {res['retrieval_cand']:.3f} ms, peak "
            f"{serve_peak / 1e9:.3f} GB; train B={b_train} step median(2..) "
            f"{res['train_step']:.3f} ms ({b_train / res['train_step'] * 1e3:.1f} examples/s), "
            f"loss {' '.join(f'{x:.4f}' for x in losses)}, peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del tr
        torch.cuda.empty_cache()
        _reduced_on_card_vs_cpu(torch, cfg, seed, "rec-family")
        out[arch] = res
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# -------------------------------------------------------------------- main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # inductor's and Triton's caches (the backends phase) inside the checkout
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch
    # inductor's notes on its softmax lowering, and torch.export's on loading
    # from a read-only buffer, once per compile or load
    warnings.filterwarnings("ignore", message=r"\s*Online softmax is disabled")
    warnings.filterwarnings("ignore", message="The given buffer is not writable")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import embedding_bag, flash_attention, sm_cnn_conv

    phases = {}
    t_all = time.perf_counter()
    t = time.perf_counter()
    dev = phase_device(torch)
    phases["device"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_build()
    phases["build"] = time.perf_counter() - t
    cfg = get_config("sm-cnn")
    t = time.perf_counter()
    kern = phase_kernel(torch, cfg)
    phases["kernel"] = time.perf_counter() - t
    t = time.perf_counter()
    pipe = phase_pipeline(torch, cfg, args.seed)
    phases["pipeline"] = time.perf_counter() - t
    world = pipe.pop("world")
    t = time.perf_counter()
    table1 = phase_backends(torch, cfg, world)
    phases["backends"] = time.perf_counter() - t
    t = time.perf_counter()
    service = phase_service(torch, cfg, world, table1)
    phases["service"] = time.perf_counter() - t
    t = time.perf_counter()
    launch = phase_launch(torch, cfg, world, service)
    phases["launch"] = time.perf_counter() - t
    del table1, world
    lm_cfg = get_config("qwen3-0.6b")
    with torch.inference_mode():
        t = time.perf_counter()
        attn = phase_attn_kernel(torch, lm_cfg)
        phases["attn-kernel"] = time.perf_counter() - t
        t = time.perf_counter()
        phase_lm_check(torch, lm_cfg, args.seed)
        phases["lm-check"] = time.perf_counter() - t
        t = time.perf_counter()
        lm = phase_lm(torch, lm_cfg, args.seed)
        phases["lm"] = time.perf_counter() - t
    # training differentiates: outside inference_mode
    t = time.perf_counter()
    attn_bwd = phase_attn_bwd(torch, lm_cfg)
    phases["attn-bwd"] = time.perf_counter() - t
    t = time.perf_counter()
    lm_train = phase_lm_train(torch, lm_cfg, args.seed)
    phases["lm-train"] = time.perf_counter() - t
    with torch.inference_mode():
        rec_cfg = get_config("dlrm-mlperf")
        t = time.perf_counter()
        bag = phase_bag_kernel(torch, rec_cfg, args.seed)
        phases["bag-kernel"] = time.perf_counter() - t
        params = bag.pop("params")
        t = time.perf_counter()
        phase_rec_check(torch, rec_cfg, params, args.seed)
        phases["rec-check"] = time.perf_counter() - t
        t = time.perf_counter()
        rec = phase_rec(torch, rec_cfg, params, args.seed)
        phases["rec"] = time.perf_counter() - t
        del params   # the 48 GB serving table
        torch.cuda.empty_cache()
    # recsys training differentiates: outside inference_mode
    t = time.perf_counter()
    bag_bwd = phase_bag_bwd(torch, rec_cfg, args.seed)
    phases["bag-bwd"] = time.perf_counter() - t
    t = time.perf_counter()
    rec_train = phase_rec_train(torch, rec_cfg, args.seed)
    phases["rec-train"] = time.perf_counter() - t
    t = time.perf_counter()
    phase_rec_family(torch, args.seed)
    phases["rec-family"] = time.perf_counter() - t
    for name, sec in phases.items():
        log(f"phase {name}: ok in {sec:.3f} s")
    log(f"total {time.perf_counter() - t_all:.3f} s on {dev['card']}")

    t32 = kern["timings"][(256, "float32")]
    tfa = attn["timings"][(LM_BATCH, LM_SEQ, "bfloat16")]
    tbg = bag["timings"]["serve_bulk"]
    tbb = bag_bwd["timing"]
    tbw = attn_bwd["timings"][(TRAIN_B, TRAIN_S)]
    tb32 = attn_bwd["timings"][(*BWD_TIMED_F32, "float32")]
    line = {"kernels": [{
        "name": "conv_tanh_maxpool", "route": "cuda", "source": sm_cnn_conv.SOURCE,
        "replaces": sm_cnn_conv.REPLACES, "launches": pipe["launches"],
        "max_abs_err": kern["max_err"]["float32"], "ms": t32["kernel"],
        "plain_ms": t32["plain"], "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": t32["library"],
        "device_ms": t32["device_ms"], "bound_ms_3xtf32": t32["bound_ms_3xtf32"],
        "launches_service": service["pallas"]["launches"],
        "launches_launch": launch["launches"],
        "design": kern["routes"]["float32"]["design"],
        "dtype": "float32", "shape": "B=256 S=64 d=50 w=5 F=100",
    }, {
        "name": "flash_attention", "route": "cuda", "source": flash_attention.SOURCE,
        "replaces": flash_attention.REPLACES, "launches": lm["launches"],
        "max_abs_err": attn["max_err"]["bfloat16"],
        "max_abs_err_float32": attn["max_err"]["float32"], "ms": tfa["kernel"],
        "plain_ms": tfa["plain"], "bound_ms": tfa["bound_ms"],
        "bound_by": tfa["bound_by"], "library_ms": tfa["library"],
        "device_ms": tfa["device_ms"], "design": attn["routes"]["bfloat16"]["design"],
        "dtype": "bfloat16", "shape": f"B={LM_BATCH} S={LM_SEQ} H={lm_cfg.n_heads} "
                                      f"Hkv={lm_cfg.n_kv_heads} d={lm_cfg.d_head}",
        "launches_train": lm_train["launches"],
        "ms_with_lse_b4": tbw["fwd_lse"], "ms_without_lse_b4": tbw["fwd"],
        "plain_ms_with_lse_b4": tbw["fwd_lse_plain"],
        "library_ms_with_lse_b4": tbw["fwd_lse_library"],
        "lse_max_abs_err": attn_bwd["lse_err"]["bfloat16"],
    }, {
        "name": "flash_attention_bwd", "route": "cuda", "source": flash_attention.BWD_SOURCE,
        "replaces": flash_attention.BWD_REPLACES,
        "gradient_of": flash_attention.REPLACES, "launches": lm_train["bwd_launches"],
        "max_abs_err": attn_bwd["max_err"]["bfloat16"],
        "max_abs_err_float32": attn_bwd["max_err"]["float32"], "ms": tbw["kernel"],
        "plain_ms": tbw["plain"], "bound_ms": tbw["bound_ms"],
        "bound_by": tbw["bound_by"], "library_ms": tbw["library"],
        "device_ms": tbw["device_ms"], "library_device_ms": tbw["library_device_ms"],
        "design": attn_bwd["routes"]["bfloat16"]["dkdv"]["design"],
        "ms_b8": attn_bwd["timings"][(8, TRAIN_S)]["kernel"],
        "ms_float32": tb32["kernel"], "plain_ms_float32": tb32["plain"],
        "library_ms_float32": tb32["library"], "bound_ms_float32": tb32["bound_ms"],
        "dtype": "bfloat16", "shape": f"B={TRAIN_B} S={TRAIN_S} H={lm_cfg.n_heads} "
                                      f"Hkv={lm_cfg.n_kv_heads} d={lm_cfg.d_head}",
    }, {
        "name": "embedding_bag", "route": "cuda", "source": embedding_bag.SOURCE,
        "replaces": embedding_bag.REPLACES, "launches": rec["launches"],
        "max_abs_err": bag["max_err"]["bfloat16"],
        "max_abs_err_float32": bag["max_err"]["float32"], "ms": tbg["kernel"],
        "plain_ms": tbg["plain"], "bound_ms": tbg["bound_ms"],
        "bound_by": tbg["bound_by"], "library_ms": tbg["library"],
        "device_ms": tbg["device_ms"], "launches_train": rec_train["launches"],
        "dtype": "bfloat16", "shape": f"serve_bulk {tbg['shape']}",
    }, {
        "name": "embedding_bag_bwd", "route": "cuda", "source": embedding_bag.BWD_SOURCE,
        "replaces": embedding_bag.BWD_REPLACES, "gradient_of": embedding_bag.REPLACES,
        "launches": rec_train["bwd_launches"], "max_abs_err": bag_bwd["max_err"]["bfloat16"],
        "max_abs_err_float32": bag_bwd["max_err"]["float32"], "ms": tbb["kernel"],
        "plain_ms": tbb["plain"], "bound_ms": tbb["bound_ms"], "bound_by": tbb["bound_by"],
        "library_ms": tbb["library"], "device_ms": tbb["device_ms"], "sort_ms": tbb["sort"],
        "dtype": "bfloat16", "shape": f"training lookup {tbb['shape']}",
    }]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
