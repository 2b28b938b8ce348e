"""The port's training launcher (``repro_torch.launch.train``) against the
JAX package's ``repro.launch.train``.

``build`` yields the same batches as the JAX launcher's ``build`` for the
LM and the text-pair families (both draw from numpy generators with the same
seeds), and parameter trees of the same names, shapes and dtypes; ``python
-m repro_torch.launch.train`` runs ``--arch sm-cnn`` and ``--arch
qwen3-0.6b`` for 3 steps on the CPU and prints the JAX launcher's lines
with a finite loss; the JAX launcher's flags are all there; a checkpoint
directory resumes; BERT4Rec and the gnn family build the JAX launcher's
batches and trees and train through ``main``; a card that is not there
raises; ``--arch`` offers the ported architectures, the MoE configs among
them, whose reduced configs train through ``main`` and print ``moe_aux``;
reduced granite-3-2b trains through ``main``, and ``--full`` trains with the
``Trainer``'s donated updates; deepseek-coder-33b builds the JAX
launcher's batches and tree; on the card an LM config with no attention
kernel for its dtype and d_head (the reduced ones: float32, d_head 16)
gets ``attn_impl="chunked"``, one the kernels take keeps ``"flash"``, and
the CPU changes nothing.
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
    """{path: (shape, dtype name)} of nested dicts and lists of arrays or
    tensors."""
    out = {}
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            out.update({f"{k}/{p}": s for p, s in _shapes(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch,batch,seq_len", [("qwen3-0.6b", 4, 16), ("sm-cnn", 8, 64),
                                                ("granite-3-2b", 4, 16),
                                                ("deepseek-coder-33b", 4, 16)])
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
    for arch in ("sm-cnn", "qwen3-0.6b", "granite-3-2b", "deepseek-coder-33b"):
        _, jparams, _, _ = jax_train.build(arch, False, 2, 8)
        _, params, _, _ = train.build(arch, False, 2, 8, device="cpu")
        assert sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams)) == \
            sum(p.numel() for p in tree_leaves(params))


def test_granite_trains_through_main_on_the_cpu(capsys):
    """Reduced granite-3-2b (tied embeddings, remat on) trains 3 steps
    through ``main``: the JAX launcher's ``arch=`` line and a finite final
    loss."""
    _, jparams, _, _ = jax_train.build("granite-3-2b", False, 16, 64)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    train.main(["--arch", "granite-3-2b", "--steps", "3", "--lr", "1e-2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch=granite-3-2b family=lm params={n:,}"
    final = ast.literal_eval(lines[-1][len("final: "):])
    assert math.isfinite(final["loss"]) and final["loss"] > 0


@pytest.mark.parametrize("full", [False, True])
def test_full_trains_with_donated_updates(full, monkeypatch, capsys):
    """``--full`` is the production setting: its ``Trainer`` donates (the
    update writes params and state in place); a reduced run does not. The
    build is held to the reduced config here, so no full model is made."""
    seen = {}
    real_build, real_trainer = train.build, train.Trainer

    def reduced_build(arch, full_, batch, seq_len, device="cuda"):
        seen["full"] = full_
        return real_build(arch, False, batch, seq_len, device)

    def recording_trainer(*args, **kw):
        seen["donate"] = kw.get("donate", False)
        return real_trainer(*args, **kw)

    monkeypatch.setattr(train, "build", reduced_build)
    monkeypatch.setattr(train, "Trainer", recording_trainer)
    train.main(["--arch", "granite-3-2b", "--steps", "2", "--batch", "2", "--seq-len", "16",
                "--device", "cpu"] + (["--full"] if full else []))
    assert seen == {"full": full, "donate": full}
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("final: {")


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


@pytest.mark.parametrize("arch,family,metric", [("bert4rec", "recsys", "ce"),
                                                ("meshgraphnet", "gnn", "mse")])
def test_bert4rec_and_gnn_build_the_jax_launchers_batches_and_tree(arch, family, metric):
    """``build`` for BERT4Rec (the recsys branch) and the gnn family (200
    nodes, 800 edges, 16 features a graph, seed i at step i): the JAX
    launcher's config, the same batches, a parameter tree of the same names,
    shapes and dtypes, and a finite loss with its metric."""
    jcfg, jparams, _, jdata = jax_train.build(arch, False, 4, 16)
    cfg, params, loss, data = train.build(arch, False, 4, 16, device="cpu")
    assert cfg.name == jcfg.name and cfg.family == jcfg.family == family
    assert _shapes(params) == _shapes(jax.tree.map(np.asarray, jparams))
    for _ in range(2):
        want, got = next(jdata), next(data)
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    value, metrics = loss(params, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in next(data).items()})
    assert value.dim() == 0 and math.isfinite(value.item()) and set(metrics) == {metric}


@pytest.mark.parametrize("arch,family,metric", [("bert4rec", "recsys", "ce"),
                                                ("meshgraphnet", "gnn", "mse")])
def test_bert4rec_and_gnn_main_train_on_the_cpu(arch, family, metric, capsys):
    """``main`` prints the JAX launcher's ``arch=`` line (its parameter
    count at the reduced config) and a finite final loss with the metric."""
    _, jparams, _, _ = jax_train.build(arch, False, 16, 64)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    train.main(["--arch", arch, "--steps", "3", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={arch} family={family} params={n:,}"
    assert lines[-1].startswith("final: {") and f"'{metric}'" in lines[-1]
    final = ast.literal_eval(lines[-1][len("final: "):])
    assert math.isfinite(final["loss"]) and final["loss"] > 0


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train.build("qwen3-0.6b", False, 2, 8)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "moonshot-v1-16b-a3b"])
def test_arch_offers_only_the_ported_architectures(arch, capsys):
    """``--arch`` offers ``ARCHS``, every architecture whose model trains in
    the port: the MoE configs among them since their training is ported.
    ``main`` trains each MoE config's reduced config on the CPU and prints
    the JAX launcher's ``arch=`` line and a ``final:`` line with the summed
    load-balance loss (``moe_aux``, above 0); an architecture outside the
    registry is refused with the usage line's choices. The reduced config
    also decodes a step on the int8 KV cache, as the JAX launcher serves a
    model above 5e9 parameters."""
    import dataclasses

    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.models import transformer as tfm
    assert len(ARCHS) == 11 and arch in ARCHS
    assert {"deepseek-coder-33b", "granite-3-2b", "qwen3-0.6b"} <= set(ARCHS)
    offered = "{" + ",".join(ARCHS) + "}"   # the usage line's choices
    with pytest.raises(SystemExit):
        train.main(["--arch", "not-an-arch", "--steps", "1", "--device", "cpu"])
    assert offered in capsys.readouterr().err
    _, jparams, _, _ = jax_train.build(arch, False, 16, 64)
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(jparams))
    train.main(["--arch", arch, "--steps", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"arch={arch} family=lm params={n:,}"
    assert lines[-1].startswith("final: {")
    final = ast.literal_eval(lines[-1][len("final: "):])
    assert math.isfinite(final["loss"]) and final["moe_aux"] > 0
    cfg = reduced(get_config(arch))
    assert get_config(arch).n_params() > 5e9
    params = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    cache = tfm.init_cache(cfgq, 1, 8, device="cpu")
    assert cache["v"].dtype == torch.int8 and cache["v_scale"].dtype == torch.float32
    logits, cache = tfm.decode_step(params, cache, torch.zeros((1,), dtype=torch.long),
                                    torch.zeros((1,), dtype=torch.int32), cfgq)
    assert tuple(logits.shape) == (1, cfg.vocab_padded)
    assert bool(torch.isfinite(logits).all()) and bool((cache["v_scale"][:, 0, 0] > 0).all())


@pytest.mark.parametrize("arch,full,dtype,want", [
    ("qwen3-0.6b", False, None, "chunked"),          # reduced: float32, d_head 16
    ("deepseek-coder-33b", False, None, "chunked"),
    ("granite-3-2b", False, None, "chunked"),
    ("deepseek-moe-16b", False, None, "chunked"),
    ("moonshot-v1-16b-a3b", False, None, "chunked"),
    ("qwen3-0.6b", True, None, "flash"),             # bfloat16, d_head 128
    ("granite-3-2b", True, None, "flash"),           # bfloat16, d_head 64
    ("deepseek-coder-33b", True, None, "flash"),     # bfloat16, d_head 128, G=7
    ("deepseek-moe-16b", True, None, "flash"),       # bfloat16, d_head 128, G=1
    ("qwen3-0.6b", True, "float32", "flash"),        # float32 at 128: both ways
    ("granite-3-2b", True, "float32", "chunked"),    # float32 at 64: no kernel
])
def test_attention_on_the_card_follows_the_kernels_tables(arch, full, dtype, want):
    """``attention_impl`` reads ``KERNEL_HEAD_DIMS`` before anything is
    allocated: on the card an LM config with no kernel instance both ways
    for its (dtype, d_head) gets ``"chunked"`` and ``kernel_gap`` says why;
    one the kernels take keeps ``"flash"``; on the CPU nothing changes, and
    ``build`` on the CPU keeps the config's own ``"flash"``. The kernel
    wrapper itself still raises on such a CUDA call."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch) if full else reduced(get_config(arch))
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    assert train.attention_impl(cfg, "cuda") == want
    assert train.attention_impl(cfg, "cpu") == cfg.attn_impl == "flash"
    gap = train.kernel_gap(cfg)
    if want == "chunked":
        assert gap == f"no CUDA kernel for {cfg.dtype} d_head {cfg.d_head}"
    else:
        assert gap is None
    if not full:
        built, *_ = train.build(arch, False, 2, 8, device="cpu")
        assert built.attn_impl == "flash"
