"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's ``repro.launch.train``.

``build`` yields the same batches as the JAX launcher's ``build`` for the
LM and the text-pair families (both draw from numpy generators with the same
seeds), and parameter trees of the same names, shapes and dtypes; ``python
-m repro_torch.launch.train`` runs ``--arch sm-cnn`` and ``--arch
qwen3-0.6b`` for 3 steps on the CPU and prints the JAX launcher's lines
with a finite loss; the JAX launcher's flags are all there; a checkpoint
directory resumes; BERT4Rec, the gnn family and a card that is not there
raise.
"""
import ast
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jax_train
from repro_torch.core.treepath import tree_leaves
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def _shapes(tree):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}/{p}": s for p, s in _shapes(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch,batch,seq_len", [("qwen3-0.6b", 4, 16), ("sm-cnn", 8, 64)])
def test_build_gives_the_jax_launchers_batches_and_tree(arch, batch, seq_len):
    jcfg, jparams, _, jdata = jax_train.build(arch, False, batch, seq_len)
    cfg, params, loss, data = train.build(arch, False, batch, seq_len, device="cpu")
    assert cfg.name == jcfg.name and cfg.family == jcfg.family
    assert _shapes(params) == _shapes(jax.tree.map(np.asarray, jparams))
    assert all(t.device.type == "cpu" for t in tree_leaves(params))
    for _ in range(3):
        want, got = next(jdata), next(data)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    value, metrics = loss(params, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in next(data).items()})
    assert value.dim() == 0 and math.isfinite(value.item())


def _run(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          env=env, cwd=str(ROOT), capture_output=True, text=True,
                          timeout=120)


@pytest.mark.parametrize("arch,family,params", [("sm-cnn", "textpair", "3,454"),
                                                ("qwen3-0.6b", "lm", "90,496")])
def test_cli_trains_three_steps_on_the_cpu(arch, family, params):
    """The JAX launcher prints the same ``arch=`` line for these reduced
    configs (``python -m repro.launch.train --arch <arch>``)."""
    out = _run("--arch", arch, "--steps", "3", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == f"arch={arch} family={family} params={params}"
    assert lines[-1].startswith("final: {")
    final = ast.literal_eval(lines[-1][len("final: "):])
    assert math.isfinite(final["loss"]) and final["loss"] > 0


def test_params_line_counts_what_the_jax_launcher_counts():
    for arch in ("sm-cnn", "qwen3-0.6b"):
        _, jparams, _, _ = jax_train.build(arch, False, 2, 8)
        _, params, _, _ = train.build(arch, False, 2, 8, device="cpu")
        assert sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams)) == \
            sum(p.numel() for p in tree_leaves(params))


def test_cli_takes_the_jax_launchers_flags_and_device(tmp_path, capsys):
    """Every flag of the JAX launcher, plus ``--device``; ``--ckpt-dir``
    checkpoints and a second run resumes where the first stopped."""
    args = ["--arch", "qwen3-0.6b", "--batch", "2", "--seq-len", "16", "--lr", "1e-3",
            "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    train.main(args + ["--steps", "2"])
    first = capsys.readouterr().out
    assert "resumed" not in first and "final:" in first
    train.main(args + ["--steps", "3"])
    second = capsys.readouterr().out
    assert "resumed at step 2" in second and "final:" in second


def test_recsys_family_is_not_ported_yet(monkeypatch):
    """BERT4Rec (the recsys kind still to port) and the gnn family raise,
    naming ROADMAP item 10e; neither is registered, so the launcher is
    handed their configs (``tests/test_torch_rec_train.py`` trains
    dlrm-mlperf, fm and din)."""
    import dataclasses
    import types

    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import RecsysConfig
    bert4rec = RecsysConfig(**dataclasses.asdict(jax_get_config("bert4rec")))
    gnn = types.SimpleNamespace(name="meshgraphnet", family="gnn")
    monkeypatch.setattr(train, "get_config",
                        lambda arch: {"bert4rec": bert4rec, "meshgraphnet": gnn}[arch])
    with pytest.raises(NotImplementedError, match="10e"):
        train.build("bert4rec", False, 4, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="10e"):
        train.build("meshgraphnet", True, 4, 16, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.build("qwen3-0.6b", False, 2, 8)
