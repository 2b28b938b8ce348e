#!/usr/bin/env python3
"""Time and profile one deepseek-moe-16b MoE layer on the card, through the
expert-parallel all-to-all and through the gather formulation.

  python3 scripts/moe_a2a_profile.py [--batch 8] [--seq 2048] [--iters 5]

Run from the root of a checkout on a machine with a CUDA card. It prints
the card's name and power limit; opens a default process group of one
rank on the ``nccl`` backend (a ``file://`` store under ``build/``) and a
(1, 1) mesh of ("data", "model") on the card; draws the layer's bfloat16
weights and a (batch, seq, 2048) input from seed 0 on the card; then,
under ``torch.inference_mode()``: the mean ms a call (CUDA events over
``iters`` calls after one warm-up) of ``moe_apply_a2a`` and of
``moe_apply``, of one ``all_to_all_single`` of the a2a's send buffer
(``cap`` rows) over the NCCL group and of a device copy of the same
bytes; and ``torch.profiler``'s table of each formulation's kernels by
device time. It destroys the group before it exits.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("moe_a2a_profile: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.distributed.mesh import make_mesh
    from repro_torch.models import moe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-moe-16b")
    store = ROOT / "build" / "moe-a2a-profile-store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        gen = torch.Generator("cuda").manual_seed(0)
        p = moe.moe_params(gen, cfg, torch.bfloat16)
        h = torch.randn(args.batch, args.seq, cfg.d_model, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        spec = cfg.moe
        cap = moe.a2a_capacity(args.batch * args.seq, spec, 1)[0]
        with torch.inference_mode():
            a2a = _ms(torch, lambda: moe.moe_apply_a2a(p, h, cfg, mesh), args.iters)
            gather = _ms(torch, lambda: moe.moe_apply(p, h, cfg), args.iters)
            send = torch.empty(1, cap, cfg.d_model, device="cuda", dtype=torch.bfloat16)
            recv = torch.empty_like(send)
            group = mesh.get_group("model")
            nccl = _ms(torch, lambda: dist.all_to_all_single(recv, send, group=group),
                       args.iters)
            copy = _ms(torch, lambda: recv.copy_(send), args.iters)
            print(f"layer B={args.batch} S={args.seq}: moe_apply_a2a {a2a:.3f} ms, moe_apply "
                  f"{gather:.3f} ms; all_to_all_single of {send.numel() * 2 / 1e9:.3f} GB over "
                  f"{dist.get_backend(group)} {nccl:.3f} ms, a device copy of it {copy:.3f} ms")
            for name, fn in (("moe_apply_a2a", lambda: moe.moe_apply_a2a(p, h, cfg, mesh)),
                             ("moe_apply", lambda: moe.moe_apply(p, h, cfg))):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fn()
                    torch.cuda.synchronize()
                print(f"{name}:")
                print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=16,
                                                max_name_column_width=70))
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
