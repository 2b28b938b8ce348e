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
            at every shape the main path gives it (and a ragged and a small
            one), in float32 and bfloat16; then its time from CUDA events,
            the plain version's, one PyTorch library call's as a yardstick,
            and the bound the card's data-sheet rates put on the same work
  pipeline  the paper's system at the full width of sm-cnn (weights from
            --seed): Retrieve(h=20) >> Rerank("pallas") % 10 planned on the
            card through PlanContext + plan, `local` on 32 queries and
            `batched` on 256; the kernel's launch counter is set to 0 just
            before and read just after, and must show 2 launches per pallas
            scorer call; then local == batched (verify_plans), pallas ==
            eager rankings, pallas scores == a CPU eager scorer, q/s, p50,
            p99, per-stage spans and the device's busy share of one batch
  attn-kernel  the causal GQA attention kernel against its plain version
            at qwen3-0.6b's H=16, Hkv=8, d=128 for (B, S) from (1, 1) to
            (1, 4096), float32 and bfloat16 (randn inputs), by max absolute
            error and by the error's norm over the output's; then at the LM
            phase's prefills (8 x 2048 both types, 1 x 32768 bfloat16): the
            same checks (at 32768 on the first and last 256 query rows
            against all keys, where the plain version's full scores would
            not fit), SDPA as a yardstick held against the kernel, times of
            the kernel, the plain version where it fits and SDPA, the bound
  lm-check  the LM path in float32 against itself: prefill through the
            kernel ("flash") == plain torch ("chunked"), logits and cache;
            decode at position S == forward over S+1 tokens
  lm        qwen3-0.6b at full width in bfloat16 (weights from --seed,
            tokens from data/lm.py): prefill 8 x 2048, 32 greedy decode
            steps on the copied cache, prefill 1 x 32768; the attention
            kernel's launch counter is set to 0 just before and read just
            after, and must show 28 launches per prefill and none in
            decode; prefill tokens/s, decode ms per step, busy shares
  bag-kernel  the EmbeddingBag kernel against its plain version: at
            tests/test_kernels.py's shapes and a ragged bag count, float32
            and bfloat16, with and without weights; in float32 over a
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
            one row is its row); reduced(dlrm-mlperf) in float32 on the
            card == on the CPU
  rec       dlrm-mlperf at full width in bfloat16, batches from
            data/recsys.py: serve_p99 (B=512, p50/p99 of 64 steps),
            serve_bulk (B=262144, examples/s, median of 3), retrieval_cand
            (1,000,000 candidates, median of 5); the bag kernel's launch
            counter is set to 0 just before and read just after, and must
            show 1 launch per serve_step and 2 per retrieval_step; peak
            memory, the busy share of one serve_bulk step

The attn-kernel, lm-check, lm, bag-kernel, rec-check and rec phases run
under torch.inference_mode().
It prints one `{"kernels": [...]}` line, then as its last line
`{"ok": true, "device": {...}}`. Any failed check raises and ends the run
with a nonzero exit; without a card, or without the repository's sources
beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data-sheet rates (NVIDIA's published dense peaks)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-5, "bfloat16": 2e-2}
#: kernel batch sizes: the scorer buckets of both plans (1..4096) and a
#: ragged one; S, d, w, F are sm-cnn's
KERNEL_BATCHES = (1, 3, 8, 64, 256, 1024, 4096)
TIMED_BATCHES = (256, 4096)
TIE_ATOL = 1e-5
#: every kernel of the port's paths (csrc/<name>.cu)
KERNELS = ("sm_cnn_conv", "flash_attention", "embedding_bag")
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
#: rec-check: serve batches and retrieval candidates
REC_CHECK_BATCHES, REC_CHECK_CANDIDATES = (512, 4096), 65536


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
            if "registers" in line or "spill" in line:
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


def _profiled_device_ms(torch, fn, name: str, iters: int = 20):
    """Mean device time of the kernels whose name holds ``name`` over
    ``iters`` calls of ``fn``, from torch.profiler (None if it saw none)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(times) / 1e3 / len(times) if times else None


def conv_bound(b: int, s: int, d: int, w: int, f: int, dtype: str):
    """Least time for the conv on the card: each input read once and the
    output written once at the memory rate, against the multiply-adds at
    the dtype's peak (tensor cores for bfloat16). Each of the S real rows
    meets each of the w taps once; products with the zero pad rows are not
    needed, so they are not counted."""
    es = 4 if dtype == "float32" else 2
    n_bytes = (b * s * d + w * d * f + f + b * f) * es
    flops = 2 * b * s * w * d * f
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations"), \
        n_bytes, flops


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

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    shapes = [(b, s, d, w, f) for b in KERNEL_BATCHES] + [(8, 16, 8, 5, 12)]
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
            dev_ms = _profiled_device_ms(
                torch, lambda: K.conv_tanh_maxpool(x, filt, bias, w), "conv_tanh_maxpool")
            bound_ms, bound_by, n_bytes, flops = conv_bound(b, s, d, w, f, dtype)
            timings[(b, dtype)] = dict(t, bound_ms=bound_ms, bound_by=bound_by,
                                       device_ms=dev_ms)
            log(f"kernel: B={b} {dtype} kernel_ms={t['kernel']:.5f} "
                f"kernel_device_ms={'not measured' if dev_ms is None else f'{dev_ms:.5f}'} "
                f"plain_ms={t['plain']:.5f} library_ms={t['library']:.5f} "
                f"(F.conv1d+tanh+amax, max_abs_err vs plain {lib_err:.2e}) "
                f"bound_ms={bound_ms:.5f} ({bound_by}: {flops / 1e9:.3f} GFLOP "
                f"at {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s, {n_bytes / 1e6:.3f} MB "
                f"at 3.35 TB/s) share_of_bound={bound_ms / t['kernel']:.3f}")
    return {"max_err": max_err, "timings": timings}


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
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
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
    return (f"device busy {busy:.3f} ms over {len(spans)} device events "
            f"({kernel} {kernel_ms:.3f} ms, {kernel_n} launches) in a "
            f"{wall_ms:.3f} ms profiled run: busy share {busy / wall_ms:.4f} "
            f"(idle {1 - busy / wall_ms:.4f}); top device time: "
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
    return {"launches": launches}


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

    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for b, s in ATTN_SHAPES:
        for dtype in ("float32", "bfloat16"):
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
        dev_ms = _profiled_device_ms(torch, fns["kernel"], "flash_attention", iters=iters)
        bound_ms, bound_by, n_bytes, flops = attention_bound(b, s, h, hkv, d, dtype)
        timings[(b, s, dtype)] = dict(t, bound_ms=bound_ms, bound_by=bound_by,
                                      device_ms=dev_ms)
        plain = f"{t['plain']:.5f}" if "plain" in t else "not run (scores too large)"
        log(f"attn-kernel: B={b} S={s} {dtype} kernel_ms={t['kernel']:.5f} "
            f"kernel_device_ms={'not measured' if dev_ms is None else f'{dev_ms:.5f}'} "
            f"plain_ms={plain} library_ms={t['library']:.5f} (SDPA causal GQA, "
            f"max_abs_err vs kernel {lib_err:.3e}) bound_ms={bound_ms:.5f} "
            f"({bound_by}: {flops / 1e12:.4f} TFLOP at {PEAK_FLOPS[dtype] / 1e12:.0f} "
            f"TFLOP/s, {n_bytes / 1e6:.3f} MB at 3.35 TB/s) "
            f"share_of_bound={bound_ms / t['kernel']:.4f} "
            f"achieved_tflops={flops / t['kernel'] / 1e9:.3f}")
        del q, k, v, qt, kt, vt, fns
        torch.cuda.empty_cache()
    return {"max_err": max_err, "timings": timings}


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
    if ids.shape[1] == 1 and weights is None:   # a bag of one row is that row
        check(exact, f"bag kernel: single-row bags are not their rows at {what} {dtype}")
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
        dev_ms = _profiled_device_ms(torch, fns["kernel"], "embedding_bag_kernel", iters=iters)
        bounds = [bag_bound(i, False, d, "bfloat16") for i in id_sets]
        bound_ms = statistics.mean(b[0] for b in bounds)
        n_bytes = statistics.mean(b[2] for b in bounds)
        distinct = statistics.mean(b[3] for b in bounds)
        b, l = id_sets[0].shape
        rows_ms = (b * l * 4 + (b * l + b) * d * 2) / HBM_BYTES_PER_S * 1e3
        timings[name] = dict(t, bound_ms=bound_ms, bound_by=bounds[0][1], device_ms=dev_ms,
                             shape=f"B={b} L={l} d={d} V={v}")
        log(f"bag-kernel: {name} B={b} L={l} bfloat16 kernel_ms={t['kernel']:.5f} "
            f"kernel_device_ms={'not measured' if dev_ms is None else f'{dev_ms:.5f}'} "
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
    through the plain version, and reduced(dlrm-mlperf) in float32 on the
    card against the CPU."""
    from repro_torch.configs import reduced
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

    small = reduced(cfg)
    cpu = rec.init_model(small, torch.Generator().manual_seed(seed), "cpu")
    card = rec.params_from_numpy(cpu, "cuda")
    batch = rec_data.batch_for(small, 256, seed=seed)
    rbatch = rec_data.retrieval_batch(small, 1000, seed=seed)
    for what, fn, b in (("serve_step B=256", rec.serve_step, batch),
                        ("retrieval_step N=1000", rec.retrieval_step, rbatch)):
        on_card = fn(card, _rec_batch(torch, b), small).cpu()
        on_cpu = fn(cpu, {k: torch.from_numpy(v) for k, v in b.items()}, small)
        err = (on_card - on_cpu).abs().max().item()
        ok = bool(torch.allclose(on_card, on_cpu, rtol=1e-4, atol=1e-5))
        log(f"rec-check: {small.name} float32 {what} on the card == on the CPU: "
            f"max_abs_err={err:.3e} (rtol=1e-4 atol=1e-5) {'ok' if ok else 'FAIL'}")
        check(ok, f"{small.name} {what}: the card disagrees with the CPU: {err}")


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
    import torch
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
        del params
        torch.cuda.empty_cache()
    for name, sec in phases.items():
        log(f"phase {name}: ok in {sec:.3f} s")
    log(f"total {time.perf_counter() - t_all:.3f} s on {dev['card']}")

    t32 = kern["timings"][(256, "float32")]
    tfa = attn["timings"][(LM_BATCH, LM_SEQ, "bfloat16")]
    tbg = bag["timings"]["serve_bulk"]
    line = {"kernels": [{
        "name": "conv_tanh_maxpool", "route": "cuda", "source": sm_cnn_conv.SOURCE,
        "replaces": sm_cnn_conv.REPLACES, "launches": pipe["launches"],
        "max_abs_err": kern["max_err"]["float32"], "ms": t32["kernel"],
        "plain_ms": t32["plain"], "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": t32["library"],
        "device_ms": t32["device_ms"],
        "dtype": "float32", "shape": "B=256 S=64 d=50 w=5 F=100",
    }, {
        "name": "flash_attention", "route": "cuda", "source": flash_attention.SOURCE,
        "replaces": flash_attention.REPLACES, "launches": lm["launches"],
        "max_abs_err": attn["max_err"]["bfloat16"],
        "max_abs_err_float32": attn["max_err"]["float32"], "ms": tfa["kernel"],
        "plain_ms": tfa["plain"], "bound_ms": tfa["bound_ms"],
        "bound_by": tfa["bound_by"], "library_ms": tfa["library"],
        "device_ms": tfa["device_ms"],
        "dtype": "bfloat16", "shape": f"B={LM_BATCH} S={LM_SEQ} H={lm_cfg.n_heads} "
                                      f"Hkv={lm_cfg.n_kv_heads} d={lm_cfg.d_head}",
    }, {
        "name": "embedding_bag", "route": "cuda", "source": embedding_bag.SOURCE,
        "replaces": embedding_bag.REPLACES, "launches": rec["launches"],
        "max_abs_err": bag["max_err"]["bfloat16"],
        "max_abs_err_float32": bag["max_err"]["float32"], "ms": tbg["kernel"],
        "plain_ms": tbg["plain"], "bound_ms": tbg["bound_ms"],
        "bound_by": tbg["bound_by"], "library_ms": tbg["library"],
        "device_ms": tbg["device_ms"],
        "dtype": "bfloat16", "shape": f"serve_bulk {tbg['shape']}",
    }]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
