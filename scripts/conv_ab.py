#!/usr/bin/env python3
"""Time one checkout's conv wrapper on the host, and its ranking pipeline.

  python3 scripts/conv_ab.py CHECKOUT [--calls 200] [--rounds 3] [--seed 0]

Run on a machine with a CUDA card. CHECKOUT is the root of a checkout of
the repository (this one, or another commit unpacked with ``git archive``);
its own ``src/repro_torch`` and ``chip_smoke.py`` are imported, so two
commits are compared by running this script once on each, taking turns
(a, b, b, a, ...), all on one card:

  host      the card's name and power limit; the conv kernel built from the
            checkout's source; then, at sm-cnn's S=64, d=50, w=5, F=100 in
            float32 and at the local plan's B=8 and B=256, the host time of
            ``conv_tanh_maxpool`` a call: ``calls`` calls issued back to back
            (the card runs them behind the host), and the same with the
            drain (until the card is done), median of ``rounds``; and at
            the scorer buckets B=8, 64, 256 and 4096 the kernel's device
            time a launch
            (torch.profiler, mean over 50 launches)
  pipeline  the checkout's ``chip_smoke.phase_pipeline``: sm-cnn at full
            width, `local` (q/s, p50, p99, spans) and `batched` (q/s, spans,
            busy share), with all its checks

Each line is printed as it is measured; a failed check raises.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path


def conv_inputs(torch, b: int):
    gen = torch.Generator(device="cuda").manual_seed(1234)
    x = torch.randn((b, 64, 50), generator=gen, device="cuda")
    filt = torch.randn((250, 100), generator=gen, device="cuda") * 0.02
    bias = torch.randn((100,), generator=gen, device="cuda") * 0.1
    return x, filt, bias


def device_ms(torch, K, b: int, iters: int = 50):
    """Mean device time of the conv kernel a launch, from torch.profiler, and
    the launches it saw (it may miss some of the ``iters``)."""
    from torch.profiler import ProfilerActivity, profile
    x, filt, bias = conv_inputs(torch, b)
    for _ in range(10):
        K.conv_tanh_maxpool(x, filt, bias, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            K.conv_tanh_maxpool(x, filt, bias, 5)
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "conv_tanh_maxpool" in e.name]
    if not times:
        raise AssertionError("the profiler saw no conv launch")
    return sum(times) / len(times) / 1e3, len(times)


def host_cost(torch, K, b: int, calls: int, rounds: int):
    """Median over rounds of (host us a call, us a call with the drain)."""
    x, filt, bias = conv_inputs(torch, b)
    for _ in range(20):
        K.conv_tanh_maxpool(x, filt, bias, 5)
    torch.cuda.synchronize()
    host, drained = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            K.conv_tanh_maxpool(x, filt, bias, 5)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / calls * 1e6)
        drained.append((t2 - t0) / calls * 1e6)
    return statistics.median(host), statistics.median(drained)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", type=Path, help="root of the checkout to measure")
    ap.add_argument("--calls", type=int, default=200, help="calls a round")
    ap.add_argument("--rounds", type=int, default=3, help="rounds of calls")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)
    root = args.checkout.resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    if not torch.cuda.is_available():
        print("conv_ab: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import build, sm_cnn_conv as K

    print(f"checkout {root}", flush=True)
    chip_smoke.phase_device(torch)
    build.compile_library("sm_cnn_conv")
    build.load_library("sm_cnn_conv")
    for b in (8, 256):
        host, drained = host_cost(torch, K, b, args.calls, args.rounds)
        print(f"host: conv_tanh_maxpool float32 B={b}: {host:.2f} us a call on the "
              f"host, {drained:.2f} us with the drain ({args.calls} calls, median "
              f"of {args.rounds})", flush=True)
    for b in (8, 64, 256, 4096):
        ms, seen = device_ms(torch, K, b)
        print(f"device: conv_tanh_maxpool float32 B={b}: {ms:.5f} ms a launch "
              f"(mean of the {seen} launches the profiler saw)", flush=True)
    chip_smoke.phase_pipeline(torch, get_config("sm-cnn"), args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
