#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

  python3 chip_smoke.py [--seed 0]

Run from the root of a checkout on a machine with an NVIDIA H100. Phases:

  device    the card's name and power limit (nvidia-smi), versions; TF32
            off for matmul and cuDNN, so float32 is compared in float32
  build     nvcc builds every kernel of the path from src/repro_torch/
            kernels/csrc (ptxas register and spill report printed)
  kernel    each kernel against its plain PyTorch version on the card at
            every shape the main path gives it (and a ragged and a small
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
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library("sm_cnn_conv")
    log(f"build: sm_cnn_conv ready in {time.perf_counter() - t0:.3f} s "
        f"(nvcc {build.BUILD_SECONDS['sm_cnn_conv']:.3f} s, sm_90a)")
    for line in build.BUILD_LOG.get("sm_cnn_conv", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


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


def _busy_share(torch, run) -> str:
    """Device busy time (union of kernel intervals) over the host wall time
    of one call of ``run``, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, conv_ms, conv_n = [], 0.0, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            if "conv_tanh_maxpool" in e.name:
                conv_ms += e.time_range.elapsed_us() / 1e3
                conv_n += 1
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
    return (f"device busy {busy:.3f} ms over {len(spans)} device events "
            f"(conv kernel {conv_ms:.3f} ms, {conv_n} launches) in a "
            f"{wall_ms:.3f} ms profiled batch: busy share {busy / wall_ms:.4f} "
            f"(idle {1 - busy / wall_ms:.4f})")


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
    from repro_torch.kernels import sm_cnn_conv

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
    for name, sec in phases.items():
        log(f"phase {name}: ok in {sec:.3f} s")
    log(f"total {time.perf_counter() - t_all:.3f} s on {dev['card']}")

    t32 = kern["timings"][(256, "float32")]
    line = {"kernels": [{
        "name": "conv_tanh_maxpool", "route": "cuda", "source": sm_cnn_conv.SOURCE,
        "replaces": sm_cnn_conv.REPLACES, "launches": pipe["launches"],
        "max_abs_err": kern["max_err"]["float32"], "ms": t32["kernel"],
        "plain_ms": t32["plain"], "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"], "library_ms": t32["library"],
        "device_ms": t32["device_ms"],
        "dtype": "float32", "shape": "B=256 S=64 d=50 w=5 F=100",
    }]}
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
