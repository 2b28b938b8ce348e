"""The port's dry run (``launch/dryrun.py``) on a fake process group of
256 and 512 ranks, on the CPU:

* ``roofline.counts`` under DTensor reads one rank's work: a (2048, 4096) x
  (4096, 4096) product of DTensors on the (16, 16) mesh counts one rank's
  2 x 128 x 256 x 4096 FLOPs (not the global product's) and the one
  all-reduce its Partial result needs; plain tensors count as before;
* a pure data-parallel cell's per-rank FLOPs are its world-1 FLOPs over the
  data size: sm-cnn ``pair_serve`` (64 pairs) over data 16 and over pod x
  data 32, through the CLI's ``run_cell`` (records ``ok``, their
  ``roofline_frac`` at most 1.05, the share gate ``chip_smoke.py`` holds);
* a dense LM's train step (qwen3-0.6b at full width cut to one layer,
  through ``specs._plan_lm``, the cell's global batch of 256 at 256
  tokens) at 256 ranks: its argument bytes
  equal the local shard sizes worked out from the plan's specs alone, its
  donated bytes those of the params and the optimizer state, and it counts
  reduce-scatters (the ZeRO gradients) and all-gathers (the FSDP weights);
* ``main`` writes a record a cell and mesh, and a skip record for an
  inapplicable cell.

Each check runs in a subprocess (``python -c``), which starts the fake
group and destroys it: a default group left in a test worker would break
the files ``--dist loadfile`` runs after this one.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed.mesh import make_mesh, mesh_shape
    from repro_torch.launch import dryrun, specs
    from repro_torch.roofline import counts
    out = {}

    def local_bytes_from_specs(plan):
        total = 0
        sizes = None
        for args, shards in zip(plan.args, plan.in_shardings):
            for t, sh in zip(leaves(args), leaves(shards)):
                sizes = mesh_shape(sh.mesh)
                n = t.numel() * t.element_size()
                for entry in sh.spec:
                    for a in (entry if isinstance(entry, tuple) else (entry,)):
                        if a is not None:
                            n //= sizes[a]
                total += n
        return total

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)) and not hasattr(tree, "spec") and not \\
                isinstance(tree, specs.P):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    # the counter under DTensor
    dryrun.start_fake_group(256)
    from torch.distributed.tensor import distribute_tensor, Replicate, Shard
    mesh = make_mesh((16, 16), ("data", "model"), "cpu")
    a = distribute_tensor(torch.empty(2048, 4096, device="meta"), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    b = distribute_tensor(torch.empty(4096, 4096, device="meta"), mesh, [Replicate(), Shard(0)],
                          src_data_rank=None)
    c = counts.count(lambda: (a @ b).redistribute(mesh, [Shard(0), Replicate()]))
    p = counts.count(lambda: torch.empty(128, 256, device="meta") @ torch.empty(256, 4096,
                                                                               device="meta"))
    out["matmul"] = [c.flops, c.n_collectives["all-reduce"], p.flops, p.bytes_accessed]

    # pure data parallelism: sm-cnn pair_serve at world 1, 256 and 512
    flops = {}
    for world, m in ((1, (1, 1)), (256, None), (512, "pod")):
        dryrun.start_fake_group(world)
        rec = dryrun.run_cell("sm-cnn", "pair_serve", m == "pod", sys.argv[1],
                              mesh_shape=m if isinstance(m, tuple) else None)
        flops[world] = (rec["ok"], rec.get("roofline", {}).get("hlo_flops_per_dev"),
                        rec.get("roofline", {}).get("roofline_frac"), rec.get("error"))
    out["smcnn"] = flops

    # a dense LM's train step at full width, one layer, at 256
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1)
    shape = ShapeSpec(name="train_t", kind="train", seq_len=256, global_batch=256)
    for world, sizes, names in ((256, (16, 16), ("data", "model")),):
        dryrun.start_fake_group(world)
        mesh = make_mesh(sizes, names, "cpu")
        plan = specs._plan_lm("qwen3-0.6b", cfg, shape, mesh)
        c, mem = dryrun.run_plan(plan, mesh)
        donated = sum(local_bytes_from_specs(dataclasses.replace(
            plan, args=(plan.args[i],), in_shardings=(plan.in_shardings[i],)))
            for i in plan.donate)
        out[f"lm{world}"] = dict(mem=mem, spec_bytes=local_bytes_from_specs(plan),
                                 donated=donated, coll=c.n_collectives, flops=c.flops)
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="2")
    script = tmp / "dry.py"
    script.write_text(SCRIPT)
    proc = subprocess.run([sys.executable, str(script), str(tmp)], capture_output=True,
                          text=True, timeout=240, env=env)
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    assert proc.returncode == 0 and line, proc.stderr[-3000:]
    return json.loads(line[0][len("RESULT "):]), tmp


def test_counts_read_one_rank_under_dtensor(runs):
    flops, all_reduce, plain_flops, plain_bytes = runs[0]["matmul"]
    assert flops == 2 * 128 * 256 * 4096 == plain_flops
    assert all_reduce == 1
    assert plain_bytes == 4 * (128 * 256 + 256 * 4096 + 128 * 4096)


def test_pure_data_parallel_flops_divide_by_the_data_size(runs):
    got = runs[0]["smcnn"]
    for world in ("1", "256", "512"):
        ok, _, frac, err = got[world]
        assert ok, err
        assert 0 < frac <= 1.05
    assert got["256"][1] * 16 == got["1"][1]
    assert got["512"][1] * 32 == got["1"][1]


def test_dense_lm_train_bytes_and_collectives(runs):
    r = runs[0]["lm256"]
    assert r["mem"]["argument_bytes"] == r["spec_bytes"]
    assert r["mem"]["alias_bytes"] == r["donated"]
    assert r["mem"]["peak_estimate_bytes"] >= r["mem"]["argument_bytes"]
    assert r["coll"]["reduce-scatter"] > 0 and r["coll"]["all-gather"] > 0
    assert r["flops"] > 0


def test_main_writes_a_record_a_cell_and_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "sm-cnn", "--shape",
         "pair_train", "--both-meshes", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=180, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: 2 ok, 0 failed" in proc.stdout
    for mesh in ("pod16x16", "pod2x16x16"):
        rec = json.loads((tmp_path / f"sm-cnn__pair_train__{mesh}.json").read_text())
        assert rec["ok"] and rec["roofline"]["roofline_frac"] <= 1.05
        assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                      "alias_bytes", "peak_estimate_bytes"}
        assert rec["meta"] == {"pairs": 256} and rec["total_s"] >= rec["run_s"]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-0.6b", "--shape",
         "long_500k", "--out", str(tmp_path)], capture_output=True, text=True, timeout=180,
        env=env)
    assert proc.returncode == 0 and "SKIP" in proc.stdout
    rec = json.loads((tmp_path / "qwen3-0.6b__long_500k__skip.json").read_text())
    assert rec["ok"] and "full-attention" in rec["skipped"]
