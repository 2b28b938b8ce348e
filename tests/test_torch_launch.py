"""The port's launcher (``launch/world.py``, ``launch/serve.py``) against the
JAX package's, at the launcher world's size (``reduced(sm-cnn)``), on the
CPU:

* the CLI takes every flag of the JAX launcher, and ``--device``;
* ``build_world`` trains what the JAX package's trains from the same
  initial tree (``init_sm_cnn_numpy`` put in place of both inits), with the
  same corpus, index and eval pairs;
* ``--describe`` prints the four lowered plans the JAX launcher prints
  (the port's plans name their device, ``local@cpu``; that tag aside, line
  for line), in process and as ``python -m repro_torch.launch.serve``;
* ``build_server`` builds the same servers from the same flags, and a
  server of either package bound to one registry version ranks alike;
  ``--ab``/``--shadow`` wrap the engine, and the flag errors are the JAX
  launcher's;
* the launcher as users start it: a subprocess serving the pipeline,
  ranked through ``Client.rank_batch``, then ``--drain`` and ``--swap``.

Every socket read, wait and join has a bound."""
import argparse
import contextlib
import io
import os
import socket
import subprocess
import sys
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import service as SV
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.treepath import tree_leaves, tree_map
from repro_torch.launch import serve, world as W
from repro_torch.models import sm_cnn
from repro_torch.serving.cluster import ReplicaPool
from repro_torch.serving.engine import PipelineEngine
from repro_torch.serving.rollout import ABEngine, ShadowEngine

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 60.0
#: the launcher world after 60 steps: both packages from one tree
WORLD_RTOL, WORLD_ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _bounded_sockets():
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(WAIT_S)
    yield
    socket.setdefaulttimeout(old)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.core import service as JSV
    from repro.launch import serve as jserve, world as jworld
    from repro.models import sm_cnn as jsm
    return types.SimpleNamespace(jax=jax, jnp=jnp, serve=jserve, world=jworld,
                                 sm_cnn=jsm, SV=JSV)


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser(main) -> argparse.ArgumentParser:
    """The parser ``main`` builds, caught at its ``parse_args``."""
    def catch(self, *a, **k):
        raise _Parsed(self)

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = catch
    try:
        main()
    except _Parsed as p:
        return p.parser
    finally:
        argparse.ArgumentParser.parse_args = real
    raise AssertionError("main never parsed its arguments")


def _flags(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_cli_takes_every_flag_of_the_jax_launcher(jx):
    port, jax_parser = _parser(serve.main), _parser(jx.serve.main)
    assert _flags(port) == _flags(jax_parser) | {"--device"}
    for a in jax_parser._actions:
        if a.dest == "help":
            continue
        twin = next(b for b in port._actions if b.dest == a.dest)
        assert (twin.default, twin.choices) == (a.default, a.choices), a.dest
    assert port.parse_args([]).device == "cuda"


# ------------------------------------------------------------------- world --

@pytest.fixture(scope="module")
def worlds(jx):
    """Both launchers' worlds from one numpy tree, 60 steps each."""
    cfg = W.reduced(W.get_config("sm-cnn"))
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sm_cnn, "init_sm_cnn",
                   lambda cfg, gen, device: sm_cnn.params_from_numpy(tree, device))
        mp.setattr(jx.sm_cnn, "init_sm_cnn",
                   lambda key, cfg: jx.jax.tree.map(jx.jnp.asarray, tree))
        port = W.build_world(train_steps=60, seed=0, device="cpu")
        jaxw = jx.world.build_world(train_steps=60, seed=0)
    return types.SimpleNamespace(port=port, jax=jaxw, tree=tree)


def test_build_world_trains_as_the_jax_launcher(worlds):
    cfg, params, corpus, tok, index, eval_pairs = worlds.port
    jcfg, jparams, jcorpus, _, jindex, jeval = worlds.jax
    assert cfg.name == jcfg.name and cfg.max_len == jcfg.max_len
    assert corpus.questions == jcorpus.questions and eval_pairs == jeval
    for f in ("term_ptr", "doc_len"):
        np.testing.assert_array_equal(np.asarray(getattr(index, f)),
                                      np.asarray(getattr(jindex, f)))
    assert all(t.device.type == "cpu" for t in tree_leaves(params))
    for a, b in zip(tree_leaves(params), tree_leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=WORLD_RTOL,
                                   atol=WORLD_ATOL)
    moved = max(float(np.abs(a.numpy() - b).max())
                for a, b in zip(tree_leaves(params), tree_leaves(worlds.tree)))
    assert moved > 1e-3                      # it trained


def test_build_world_is_seeded_and_needs_a_card_for_cuda():
    a = W.build_world(train_steps=1, seed=0, device="cpu")[1]
    b = W.build_world(train_steps=1, seed=0, device="cpu")[1]
    c = W.build_world(train_steps=1, seed=1, device="cpu")[1]
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            W.build_world(train_steps=1, device="cuda")


def test_eval_batches_and_percentiles_match_jax(jx, worlds):
    cfg, _, corpus, tok, _, pairs = worlds.port
    jcfg, _, jcorpus, jtok, _, _ = worlds.jax
    got = W.eval_batches(corpus, tok, cfg, pairs, 16)
    want = jx.world.eval_batches(jcorpus, jtok, jcfg, pairs, 16)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    lat = list(np.random.default_rng(0).random(101))
    assert W.percentile_stats(lat) == jx.world.percentile_stats(lat)


# ---------------------------------------------------------------- describe --

def _strip_device(text: str) -> str:
    return text.replace("@cpu:", ":")


@pytest.mark.parametrize("backend", ["numpy", "eager", "pallas"])
def test_describe_matches_the_jax_launcher(jx, worlds, backend):
    args = _parser(serve.main).parse_args(["--backend", backend, "--device", "cpu"])
    jargs = _parser(jx.serve.main).parse_args(["--backend", backend])
    got = serve.describe_plans(args, *worlds.port[:5])
    want = jx.serve.describe_plans(jargs, *worlds.jax[:5])
    assert "local@cpu:" in got
    assert _strip_device(got) == want
    assert len(want.splitlines()) == 5


def test_describe_cli_matches_the_jax_launcher(jx):
    """``python -m repro_torch.launch.serve --describe --device cpu
    --train-steps 1`` against the JAX launcher's plans of its own world
    (the plans do not depend on the weights)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--describe", "--device", "cpu", "--train-steps", "1",
                          "--backend", "numpy"], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=WAIT_S)
    assert out.returncode == 0, out.stderr
    jargs = _parser(jx.serve.main).parse_args(["--backend", "numpy"])
    want = jx.serve.describe_plans(jargs, *jx.world.build_world(train_steps=1)[:5])
    assert _strip_device(out.stdout.strip()) == want


# ------------------------------------------------------------ build_server --

@pytest.fixture(scope="module")
def reg_dir(worlds, tmp_path_factory):
    """A registry with the world's trained weights and a second version."""
    directory = str(tmp_path_factory.mktemp("registry"))
    reg = ModelRegistry(directory)
    params = worlds.port[1]
    va = reg.publish(params, model="sm-cnn").version_id
    vb = reg.publish(tree_map(lambda t: t * 1.5, params), model="sm-cnn").version_id
    return directory, va, vb


def _serve_args(main, *extra):
    return _parser(main).parse_args(["--backend", "numpy", *extra])


def test_pipeline_server_ranks_as_the_jax_launchers(jx, worlds, reg_dir):
    """``--serve-pipeline --server threadpool --plan-target remote`` with one
    registry version: each package's server (a ReplicaPool inside) answers
    ``rank_batch`` alike."""
    directory, va, _ = reg_dir
    flags = ["--serve-pipeline", "--server", "threadpool", "--plan-target", "remote",
             "--registry", directory, "--model-version", va, "--replicas", "3"]
    args = _serve_args(serve.main, *flags, "--device", "cpu")
    jargs = _serve_args(jx.serve.main, *flags)
    cfg, params, corpus, tok, index, _ = worlds.port
    srv, pool = serve.build_server(args, cfg, params, corpus, tok, index=index)
    jsrv, jpool = jx.serve.build_server(jargs, *worlds.jax[:4], index=worlds.jax[4])
    queries = list(corpus.questions[:6])
    try:
        assert type(srv).__name__ == type(jsrv).__name__ == "ThreadPoolServer"
        assert isinstance(pool, ReplicaPool) and len(pool.replicas) == 3
        assert pool.model_version == jpool.model_version == va
        srv.start_background()
        jsrv.start_background()
        with SV.Client(srv.address) as cl, jx.SV.Client(jsrv.address) as jcl:
            got, want = cl.rank_batch(queries), jcl.rank_batch(queries)
            assert cl.version() == (va, "active")
    finally:
        for s, p in ((srv, pool), (jsrv, jpool)):
            s.stop()
            p.stop()
    assert [[(d, s) for d, s, _ in r] for r in got] == \
           [[(d, s) for d, s, _ in r] for r in want]
    np.testing.assert_allclose([[x for _, _, x in r] for r in got],
                               [[x for _, _, x in r] for r in want],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("server", ["simple", "threadpool"])
def test_pair_servers_score_as_the_jax_launchers(jx, worlds, reg_dir, server):
    """Pair-scoring servers over the same weights (the JAX world's, put in
    the port's world): the same server type, the same scores."""
    args = _serve_args(serve.main, "--server", server, "--device", "cpu")
    jargs = _serve_args(jx.serve.main, "--server", server)
    cfg, _, corpus, tok, index, _ = worlds.port
    params = sm_cnn.params_from_numpy(
        jx.jax.tree.map(np.asarray, worlds.jax[1]), "cpu")
    srv, pool = serve.build_server(args, cfg, params, corpus, tok, index=index)
    jsrv, jpool = jx.serve.build_server(jargs, *worlds.jax[:4], index=worlds.jax[4])
    pairs = [(q, corpus.documents[i][0]) for i, q in enumerate(corpus.questions[:8])]
    try:
        assert type(srv).__name__ == type(jsrv).__name__
        assert (pool is None) == (jpool is None) == (server == "simple")
        srv.start_background()
        jsrv.start_background()
        with SV.Client(srv.address) as cl, jx.SV.Client(jsrv.address) as jcl:
            got, want = cl.get_score_batch(pairs), jcl.get_score_batch(pairs)
    finally:
        for s, p in ((srv, pool), (jsrv, jpool)):
            s.stop()
            if p is not None:
                p.stop()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_rollout_flags_wrap_the_engine(worlds, reg_dir):
    directory, va, vb = reg_dir
    cfg, params, corpus, tok, index, _ = worlds.port
    args = _serve_args(serve.main, "--serve-pipeline", "--registry", directory,
                       "--model-version", va, "--ab", f"{vb}:25", "--shadow", vb,
                       "--device", "cpu")
    srv, pool = serve.build_server(args, cfg, params, corpus, tok, index=index)
    try:
        shadow = srv.handler
        assert isinstance(shadow, ShadowEngine) and pool is None
        assert isinstance(shadow.primary, ABEngine)
        assert shadow.primary.split_pct == 25.0
        assert shadow.primary.arm_b.model_version == vb
        assert shadow.candidate.model_version == vb
        assert shadow.model_version == f"{va}|{vb}"
    finally:
        srv.stop()


@pytest.mark.parametrize("flags, message", [
    (["--model-version", "latest"], "needs --registry"),
    (["--serve-pipeline", "--plan-target", "remote", "--shadow", "x",
      "--registry", "DIR"], "in-process candidate"),
])
def test_flag_errors_are_the_jax_launchers(jx, worlds, reg_dir, flags, message):
    flags = [reg_dir[0] if f == "DIR" else f for f in flags]
    cfg, params, corpus, tok, index, _ = worlds.port
    with pytest.raises(SystemExit, match=message):
        serve.build_server(_serve_args(serve.main, *flags, "--device", "cpu"),
                           cfg, params, corpus, tok, index=index)
    with pytest.raises(SystemExit, match=message):
        jx.serve.build_server(_serve_args(jx.serve.main, *flags), *worlds.jax[:4],
                              index=worlds.jax[4])


# ---------------------------------------- the launcher as users start it --

def _read_ready(proc, timeout_s):
    """The ``FABRIC_READY host port`` line, read on a thread with a bound."""
    found = {}

    def read():
        for line in proc.stdout:
            if line.startswith("FABRIC_READY "):
                _, host, port = line.split()
                found["address"] = (host, int(port))
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout_s)
    assert "address" in found, "the launcher never printed FABRIC_READY"
    return found["address"]


def _main_output(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    return buf.getvalue().strip()


def test_launcher_subprocess_serves_swaps_and_drains(worlds, reg_dir):
    """``python -m repro_torch.launch.serve --serve-pipeline --server
    threadpool --device cpu`` bound to a registry version: it prints its
    address, ranks as the in-process engine on that version does, hot-swaps
    over ``--swap``, and drains on ``--drain``."""
    directory, va, vb = reg_dir
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--serve-pipeline",
         "--server", "threadpool", "--backend", "numpy", "--device", "cpu",
         "--train-steps", "1", "--port", "0", "--registry", directory,
         "--model-version", va], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=str(ROOT))
    try:
        host, port = _read_ready(proc, WAIT_S)
        cfg, params, corpus, tok, index, _ = worlds.port
        queries = list(corpus.questions[:4])
        with SV.Client((host, port)) as cl:
            got = cl.rank_batch(queries)
        ctx = serve.PlanContext.from_world(
            cfg, params, corpus, tok, index, buckets=(1, 8, 64, 256),
            registry=ModelRegistry(directory), model_version=va, device="cpu")
        want = PipelineEngine(serve.canonical_pipeline("numpy"), ctx).rank_batch(queries)
        assert [[(d, s) for d, s, _ in r] for r in got] == \
               [[(d, s) for d, s, _ in r] for r in want]
        assert _main_output(["--swap", vb, "--host", host, "--port", str(port)]) == \
            f"swap acknowledged: version={vb} status=swapped"
        drained = _main_output(["--drain", f"{host}:{port}"])
        assert drained.startswith("drain acknowledged:") and "draining=1" in drained
    finally:
        proc.terminate()
        try:
            proc.wait(WAIT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(WAIT_S)
        proc.stdout.close()
