#!/usr/bin/env python3
"""Time one checkout's attention kernels, forward and backward, on the card.

  python3 scripts/attn_ab.py CHECKOUT [--iters 20] [--rounds 5]

Run on a machine with a CUDA card. CHECKOUT is the root of a checkout of
the repository (this one, or another commit unpacked with ``git archive``
into a directory ``.gitignore`` lists); its own ``src/repro_torch`` is
imported and its ``csrc/flash_attention.cu`` built, so two commits are
compared by running this script once on each, taking turns (a, b, b, a,
...), all in one call on one card.

It prints the card's name and power limit, then for each shape of
``SHAPES`` (the LM prefills of ``chip_smoke.py``: qwen3-0.6b's H=16/Hkv=8
in bfloat16 and float32, deepseek-moe-16b's 16/16, granite-3-2b's 32/8 at
d=64, and deepseek-coder-33b's 56/8, all at 8 x 2048) and of
``BWD_SHAPES`` (the backward at the training steps' 4 x 2048: the same
heads, and 16/2 for G=8) one JSON line: the kernel's device ms a call
(``iters`` calls queued behind a spin kernel between two CUDA events, so
they run back to back; the median of ``rounds``), or ``"refused"`` where
the checkout's wrapper raises ``ValueError`` for the shape. A backward
row times ``_launch_bwd`` on the forward kernel's own out and lse.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

#: (dtype, B, S, H, Hkv, d)
SHAPES = (("bfloat16", 8, 2048, 16, 8, 128), ("float32", 8, 2048, 16, 8, 128),
          ("bfloat16", 8, 2048, 16, 16, 128), ("bfloat16", 8, 2048, 32, 8, 64),
          ("bfloat16", 8, 2048, 56, 8, 128))
#: (dtype, B, S, H, Hkv, d) of the backward
BWD_SHAPES = (("bfloat16", 4, 2048, 16, 8, 128), ("float32", 4, 2048, 16, 8, 128),
              ("bfloat16", 4, 2048, 16, 16, 128), ("bfloat16", 4, 2048, 16, 2, 128),
              ("bfloat16", 4, 2048, 32, 8, 64), ("bfloat16", 4, 2048, 56, 8, 128))


def queued_ms(torch, fn, iters: int) -> float:
    """Device ms a call of ``fn``: ``iters`` calls queued behind a spin
    kernel, timed between two events; the spin doubles until the host
    finished queueing before the card reached the first event."""
    cycles = 1 << 24
    for _ in range(6):
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
    raise AssertionError(f"the host could not queue {iters} calls ahead of the card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkout", type=Path)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    src = args.checkout.resolve() / "src"
    if not (src / "repro_torch").is_dir():
        print(f"attn_ab: no src/repro_torch under {args.checkout}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("attn_ab: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as FA

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(f"attn_ab: {args.checkout} on {card}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        rows = [("forward", shape) for shape in SHAPES]
        rows += [("backward", shape) for shape in BWD_SHAPES]
        for direction, (dtype, b, s, h, hkv, d) in rows:
            dt = getattr(torch, dtype)
            q, k, v, dout = (torch.randn((b, s, n, d), generator=gen, device="cuda").to(dt)
                             for n in (h, hkv, hkv, h))
            row = {"checkout": str(args.checkout), "direction": direction, "dtype": dtype,
                   "shape": f"B={b} S={s} H={h} Hkv={hkv} d={d}", "card": card}
            if direction == "forward":
                def call():
                    return FA.flash_attention(q, k, v)
            else:
                def call():
                    return FA._launch_bwd(q, k, v, out, lse, dout)
            try:
                if direction == "backward":
                    out, lse = FA._launch(q, k, v, with_lse=True)
                call()
            except ValueError as e:
                row["device_ms"] = "refused"
                row["reason"] = str(e)
            else:
                for _ in range(5):
                    call()
                times = [queued_ms(torch, call, args.iters) for _ in range(args.rounds)]
                row["device_ms"] = statistics.median(times)
                row["rounds_ms"] = times
            print(json.dumps(row), flush=True)
            del q, k, v, dout
            out = lse = None
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
