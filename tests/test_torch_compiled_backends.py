"""The port's compiled backends, ``jit`` and ``aot``, held against the JAX
package on ``reduced(sm-cnn)`` at one bucket (inductor takes seconds a
program here): each agrees with the JAX backend of the same name and with
``repro.models.sm_cnn.score`` (rtol 1e-4, atol 1e-5), ``aot`` pads to its
bucket (1e-5 / 1e-6), compiles nothing on a call and takes the rows alone as
its programs' inputs (the weights frozen into constants; weights left as
inputs are refused), ``jit`` compiles once a bucket, and neither hides a
fallback: a graph break, a hit of dynamo's recompile limit and a disabled
dynamo raise. Inductor compiles with one thread here, so that the
suite's workers do not each start a pool.

The ``cuda``-marked tests hold every backend on the card against ``eager``
on the card and show ``aot`` replaying one CUDA graph a call; they skip
where no card is present. The JAX side is imported by a fixture, so that
they also run on a machine with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_compiled_backends.py
"""
import socket
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import backends as BK
from repro_torch.models import sm_cnn

N = 8
WAIT_S = 120.0   # every join and socket read here: a compile takes seconds


@pytest.fixture(scope="module", autouse=True)
def one_compile_thread():
    from torch._inductor import config as inductor_config
    with inductor_config.patch(compile_threads=1):
        yield


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.core import backends
    from repro.models import sm_cnn as jsm
    return types.SimpleNamespace(jax=jax, jnp=jnp, cfg=jreduced(jget("sm-cnn")),
                                 backends=backends, sm_cnn=jsm)


def _inputs(cfg, n=N, seed=0):
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=3)
    tree["embed"] = tree["embed"] * 50.0   # spread the scores apart
    rng = np.random.default_rng(seed)
    q = rng.integers(0, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    a = rng.integers(0, cfg.vocab_size, (n, cfg.max_len)).astype(np.int32)
    f = rng.random((n, 4), np.float32)
    return tree, q, a, f


@pytest.fixture(scope="module")
def setup(jx):
    cfg = reduced(get_config("sm-cnn"))
    tree, q, a, f = _inputs(cfg)
    jparams = jx.jax.tree.map(jx.jnp.asarray, tree)
    ref = np.asarray(jx.sm_cnn.score(jparams, q, a, f, jx.cfg))
    return cfg, tree, jparams, q, a, f, ref


@pytest.fixture(scope="module")
def scorers(setup):
    """One scorer of each compiled backend: ``jit`` over buckets (1, 8) (only
    8 is compiled, by its first call), ``aot`` over bucket 8."""
    cfg, tree, *_ = setup
    return {"jit": BK.make_scorer("jit", tree, cfg, buckets=(1, N), device="cpu"),
            "aot": BK.make_scorer("aot", tree, cfg, buckets=(N,), device="cpu")}


@pytest.mark.parametrize("backend", ["jit", "aot"])
def test_compiled_backend_agrees_with_jax(jx, setup, scorers, backend):
    cfg, tree, jparams, q, a, f, ref = setup
    got = scorers[backend](q, a, f)
    want = jx.backends.make_scorer(backend, jparams, jx.cfg, buckets=(1, N))(q, a, f)
    assert got.shape == (N,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert np.ptp(ref) > 1e-2


def test_aot_pads_to_its_bucket(setup, scorers):
    cfg, tree, _, q, a, f, ref = setup
    got = scorers["aot"](q[:3], a[:3], f[:3])    # 3 -> padded to bucket 8
    assert got.shape == (3,)
    np.testing.assert_allclose(got, ref[:3], rtol=1e-5, atol=1e-6)


def test_aot_compiled_every_bucket_at_build_and_compiles_nothing_on_a_call(setup, scorers):
    from torch._dynamo.utils import counters
    cfg, tree, _, q, a, f, ref = setup
    aot = scorers["aot"]
    assert aot.programs.compiles == 1 and aot.programs.replays == 0   # no graphs on the CPU
    assert aot.programs.inputs == [3]   # the rows alone: the weights are constants
    graphs = counters["stats"]["unique_graphs"]
    for n in (N, 5, 1):
        aot(q[:n], a[:n], f[:n])
    assert aot.programs.compiles == 1
    assert counters["stats"]["unique_graphs"] == graphs


def test_jit_compiles_a_bucket_once(setup, scorers):
    cfg, tree, _, q, a, f, ref = setup
    jit = scorers["jit"]
    jit(q, a, f)
    compiles = jit.programs.compiles
    assert compiles >= 1
    for n in (N, 6, 2):                          # all pad to bucket 8
        np.testing.assert_allclose(jit(q[:n], a[:n], f[:n]), ref[:n], rtol=1e-5, atol=1e-6)
    assert jit.programs.compiles == compiles == 1


def test_jit_first_calls_from_many_threads_compile_once(setup):
    """Threads that make a bucket's first call at once (a server's workers)
    compile it once between them, and none takes another's compile for a
    call that ran without a program."""
    cfg, tree, _, q, a, f, ref = setup
    jit = BK.make_scorer("jit", tree, cfg, buckets=(N,), device="cpu")
    start = threading.Barrier(4, timeout=WAIT_S)
    got, errors = {}, []

    def call(i):
        try:
            start.wait()
            got[i] = jit(q, a, f)
        except Exception as e:   # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert jit.programs.compiles == 1 and len(got) == 4
    for out in got.values():
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_recompile_limit_hit_raises_instead_of_running_eager(setup, scorers):
    """Bucket 1 needs a second program; with the limit lowered to one,
    dynamo would run the plain model, and fullgraph=True makes it raise."""
    from torch._dynamo import config as dynamo_config
    from torch._dynamo.exc import FailOnRecompileLimitHit
    cfg, tree, _, q, a, f, _ = setup
    jit = scorers["jit"]
    jit(q, a, f)                                 # bucket 8 compiled
    compiles = jit.programs.compiles
    with dynamo_config.patch(recompile_limit=1), pytest.raises(FailOnRecompileLimitHit):
        jit(q[:1], a[:1], f[:1])
    assert jit.programs.compiles == compiles


def test_aot_refuses_weights_left_as_program_inputs(setup, monkeypatch):
    """Freezing folds ``nn.Parameter`` leaves only: weights closed over as
    plain tensors stay inputs of the program (the 3 rows and every weight),
    and the build raises instead of serving them as ``aot``."""
    from repro_torch.core import export
    cfg, tree, *_ = setup
    n_inputs = 3 + len(export.flatten_named(tree))
    monkeypatch.setattr(BK, "_as_parameters", lambda t: t)
    with pytest.raises(RuntimeError, match=rf"\[{n_inputs}\] inputs"):
        BK.make_scorer("aot", tree, cfg, buckets=(N,), device="cpu")


def test_dynamo_disabled_raises_instead_of_running_eager(setup):
    from torch._dynamo import config as dynamo_config
    cfg, tree, _, q, a, f, _ = setup
    with dynamo_config.patch(disable=True):
        jit = BK.make_scorer("jit", tree, cfg, buckets=(N,), device="cpu")
        with pytest.raises(RuntimeError):
            jit(q, a, f)
        with pytest.raises(RuntimeError):
            BK.make_scorer("aot", tree, cfg, buckets=(N,), device="cpu")
    assert jit.programs.compiles == 0


def test_graph_break_raises():
    stats = BK.ProgramStats()
    program = BK._compile(lambda x: (torch._dynamo.graph_break(), x + 1)[1], stats, (1,))
    with pytest.raises(torch._dynamo.exc.Unsupported):
        program(torch.ones(1))
    assert stats.compiles == 0


def test_more_buckets_than_the_recompile_limit_are_refused(setup):
    from torch._dynamo import config as dynamo_config
    cfg, tree, *_ = setup
    with pytest.raises(ValueError, match="recompile_limit"):
        BK.make_scorer("jit", tree, cfg, buckets=tuple(range(1, dynamo_config.recompile_limit + 2)),
                       device="cpu")


# -------------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the conv kernel have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend", BK.BACKENDS)
def test_cuda_backend_agrees_with_eager_on_the_card(cuda_device, backend):
    cfg = get_config("sm-cnn")
    tree, q, a, f = _inputs(cfg, n=37)
    buckets = (1, 8, 64)
    want = BK.make_scorer("eager", tree, cfg, buckets=buckets, device=cuda_device)(q, a, f)
    scorer = BK.make_scorer(backend, tree, cfg, buckets=buckets, device=cuda_device)
    for n in (37, 8, 1):
        np.testing.assert_allclose(scorer(q[:n], a[:n], f[:n]), want[:n], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_aot_replays_one_graph_a_call(cuda_device):
    cfg = get_config("sm-cnn")
    tree, q, a, f = _inputs(cfg, n=64)
    aot = BK.make_scorer("aot", tree, cfg, buckets=(8, 64), device=cuda_device)
    assert aot.programs.compiles == 2 and aot.programs.replays == 0
    want = BK.make_scorer("eager", tree, cfg, buckets=(8, 64), device=cuda_device)(q, a, f)
    for n in (64, 8, 3, 64):
        np.testing.assert_allclose(aot(q[:n], a[:n], f[:n]), want[:n], rtol=1e-4, atol=1e-5)
    assert aot.programs.replays == 4 and aot.programs.compiles == 2


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["aot", "jit"])
def test_cuda_threadpool_clients_each_get_their_own_scores(cuda_device, backend):
    """Eight clients at once, each with pairs of its own, through a
    ThreadPoolServer of eight workers over one scorer on the card: every
    reply is its own pair's score in process (``aot`` replays one graph a
    bucket, whose static inputs and output concurrent calls share)."""
    from repro_torch.core import service as SV
    from repro_torch.data import qa as QA
    from repro_torch.data.tokenizer import HashingTokenizer

    cfg = get_config("sm-cnn")
    tree, *_ = _inputs(cfg)
    corpus = QA.generate_corpus(n_docs=40, n_questions=40, seed=11)
    tok = HashingTokenizer(cfg.vocab_size)
    scorer = BK.make_scorer(backend, tree, cfg, buckets=(1, 8), device=cuda_device)
    handler = SV.QuestionAnsweringHandler(scorer, tok, corpus.idf, cfg.max_len)
    pairs = [(corpus.questions[qi], corpus.documents[di][si])
             for qi, di, si, _ in corpus.pairs[:8 * 40]]
    want = np.asarray([handler.get_scores([p])[0] for p in pairs])
    assert len(pairs) == 8 * 40 and np.ptp(want) > 1e-2
    got = {}
    old = socket.getdefaulttimeout()
    socket.setdefaulttimeout(WAIT_S)
    try:
        with SV.ThreadPoolServer(handler, num_workers=8).start_background() as srv:
            def client(c):
                with SV.Client(srv.address) as cl:
                    got[c] = [cl.get_score(q, a) for q, a in pairs[c::8]]

            threads = [threading.Thread(target=client, args=(c,)) for c in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
    finally:
        socket.setdefaulttimeout(old)
    assert not any(t.is_alive() for t in threads) and len(got) == 8
    for c in range(8):
        np.testing.assert_allclose(got[c], want[c::8], rtol=1e-4, atol=1e-5)
