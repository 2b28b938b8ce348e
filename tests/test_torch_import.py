"""The port stands alone: importing it loads neither ``jax`` nor the JAX
package ``repro``, and no file of it names either."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_slice_modules_are_all_there():
    mods = set(_modules())
    for m in ("repro_torch", "repro_torch.configs", "repro_torch.configs.base",
              "repro_torch.configs.sm_cnn", "repro_torch.data.tokenizer",
              "repro_torch.data.featurize", "repro_torch.data.qa",
              "repro_torch.serving.telemetry", "repro_torch.core.treepath",
              "repro_torch.core.export", "repro_torch.models.sm_cnn",
              "repro_torch.kernels.sm_cnn_conv", "repro_torch.kernels.build",
              "repro_torch.kernels.ops", "repro_torch.core.backends",
              "repro_torch.core.bm25", "repro_torch.core.pipeline",
              "repro_torch.core.batch_pipeline", "repro_torch.core.ops",
              "repro_torch.core.plan", "repro_torch.core.wire",
              "repro_torch.configs.qwen3_0_6b", "repro_torch.data.lm",
              "repro_torch.models.layers", "repro_torch.models.transformer",
              "repro_torch.kernels.flash_attention",
              "repro_torch.configs.dlrm_mlperf", "repro_torch.data.recsys",
              "repro_torch.models.recsys", "repro_torch.kernels.embedding_bag",
              "repro_torch.core.numpy_eval", "repro_torch.core.compiled_artifact",
              "repro_torch.core.registry", "repro_torch.core.service",
              "repro_torch.serving.stats", "repro_torch.serving.admission",
              "repro_torch.serving.batcher", "repro_torch.serving.engine",
              "repro_torch.serving.hedge", "repro_torch.training",
              "repro_torch.training.optimizer", "repro_torch.training.fault_tolerance",
              "repro_torch.training.checkpoint", "repro_torch.training.train_loop",
              "repro_torch.launch", "repro_torch.launch.world",
              "repro_torch.launch.serve", "repro_torch.serving.cluster",
              "repro_torch.serving.rollout", "repro_torch.serving.fabric",
              "repro_torch.launch.train"):
        assert m in mods, m


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _alone(module):
    """The forbidden modules loaded by importing ``module`` alone in a
    fresh process."""
    code = (f"import json, sys, {module}\n"
            "print(json.dumps(sorted(n for n in sys.modules\n"
            f"                      if n.split('.')[0] in {FORBIDDEN!r})))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ["repro_torch.models.transformer",
                                    "repro_torch.kernels.flash_attention"])
def test_the_lm_path_alone_loads_no_jax_and_no_repro(module):
    """Each entry module of the LM path, imported alone in a fresh process."""
    assert _alone(module) == []


@pytest.mark.parametrize("module", ["repro_torch.models.recsys",
                                    "repro_torch.kernels.embedding_bag",
                                    "repro_torch.data.recsys"])
def test_the_dlrm_path_alone_loads_no_jax_and_no_repro(module):
    """Each entry module of the DLRM serving path, imported alone in a
    fresh process."""
    assert _alone(module) == []


@pytest.mark.parametrize("module", ["repro_torch.core.service",
                                    "repro_torch.serving.engine",
                                    "repro_torch.serving.hedge"])
def test_the_service_alone_loads_no_jax_and_no_repro(module):
    """The service's entry modules, each imported alone in a fresh process;
    between them they import every module of the service (``wire``,
    ``stats``, ``admission``, ``batcher``)."""
    assert _alone(module) == []


@pytest.mark.parametrize("module", [
    "repro_torch.launch.serve", "repro_torch.serving.fabric",
    "repro_torch.training.train_loop",
    "repro_torch.launch.serve, repro_torch.serving.fabric, "
    "repro_torch.training.train_loop", "repro_torch.launch.train"])
def test_the_launcher_alone_loads_no_jax_and_no_repro(module):
    """The launcher, the fabric and the trainer, each imported alone in a
    fresh process, and the three together (the fabric's workers run
    ``python -m repro_torch.launch.serve``)."""
    assert _alone(module) == []


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_of_the_port_names_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Name):
            names = [node.id]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names = [a.value for a in node.args if isinstance(a, ast.Constant)]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (
                f"{path.relative_to(ROOT)}:{node.lineno} names {name!r}")
