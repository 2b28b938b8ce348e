"""The port's training package against the JAX package's
(``tests/test_training.py`` and ``tests/test_system.py``'s training cases,
mirrored), at ``reduced(sm-cnn)`` with every input drawn from numpy seeds:

* ``adamw``, ``adam``, ``sgd``, the schedules, ``global_norm`` and
  ``clip_by_global_norm``: one update of the same tree against JAX (rtol
  1e-6), the state's keys and values too;
* one ``Trainer`` step from ``init_sm_cnn_numpy`` against JAX's (params rtol
  1e-5, atol 1e-6); a 40-step loss trace against JAX's (the target is 1e-4
  relative; the port stays within 1e-6 here), then equal top-5 rankings
  on 5 questions through every CPU backend;
* ties in the max-pool: a filter's max tied over windows of PAD rows and
  one with a real token in a row the filter weighs by zero, so the tie
  is exact while the windows differ; the gradients equal JAX's (both split
  evenly; a max that gave one window the gradient fails this);
* checkpoints written by either package restore in the other, the params
  file byte-equal for one tree; ``publish_checkpoint`` ids equal across
  packages; ``retry_step`` leaves the params as they were after a step
  that raised, and its retry applies the update once;
* the donated (in-place) update of ``adamw``, ``adam`` and ``sgd`` and the
  in-place clip equal to the functional ones bit for bit, each tensor
  keeping its storage; a donated ``Trainer`` equal to a functional one; a
  donated step whose update failed raising ``StepFailure`` unretried, and
  one that failed before its update retried.

The JAX side is imported by a fixture, so the ``cuda``-marked tests (the
``Trainer`` on the card against the CPU) run where JAX is not installed."""
import functools
import os
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import backends as BK
from repro_torch.core import bm25 as BM
from repro_torch.core import pipeline as PL
from repro_torch.core.registry import ModelRegistry
from repro_torch.core.treepath import tree_leaves, tree_map
from repro_torch.data import qa as QA
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.models import sm_cnn
from repro_torch.training import fault_tolerance as FT
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import (adamw, clip_by_global_norm,
                                            constant_schedule, global_norm, sgd,
                                            warmup_cosine_schedule)
from repro_torch.training.train_loop import Trainer

torch.set_num_threads(2)

OPT_RTOL = 1e-6
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
#: the 40-step loss trace: the target tolerance; the port's trace stays
#: within 1e-6 of JAX's on this corpus (3.1e-7 at worst when written)
TRACE_RTOL = 1e-4
TRACE_STEPS = 40


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduced as jreduced
    from repro.core import backends, bm25, pipeline, registry
    from repro.data import qa
    from repro.data.tokenizer import HashingTokenizer as JTok
    from repro.models import sm_cnn as jsm
    from repro.training import checkpoint, optimizer, train_loop
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cfg=jreduced(jget("sm-cnn")), backends=backends,
        bm25=bm25, pipeline=pipeline, registry=registry, qa=qa, Tok=JTok,
        sm_cnn=jsm, checkpoint=checkpoint, optimizer=optimizer,
        train_loop=train_loop)


def _cfg():
    return reduced(get_config("sm-cnn"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32) if np.asarray(x).dtype.kind == "f" \
        else np.asarray(x)


def _assert_trees_close(got, want, rtol, atol=0.0):
    """``tree_leaves`` takes the leaves of a JAX tree in ``jax.tree.leaves``
    order too."""
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol, atol=atol)


def _tree(seed=0):
    """A small tree with nesting and a list, float32, from a seed."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "layer": {"b": rng.standard_normal((4,)).astype(np.float32),
                      "k": [rng.standard_normal((2, 2)).astype(np.float32),
                            rng.standard_normal((5,)).astype(np.float32)]}}


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jnp(jx, tree):
    return jx.jax.tree.map(jx.jnp.asarray, tree)


# -------------------------------------------------------------- optimizers --

OPTIMIZERS = {
    "adamw": (lambda m: m.adamw(3e-2)),
    "adamw_decay_schedule": (lambda m: m.adamw(
        m.warmup_cosine_schedule(1e-2, warmup=1, total=5), weight_decay=0.1,
        clip_norm=0.5)),
    "adam_unclipped": (lambda m: m.adam(1e-3, clip_norm=None)),
    "sgd": (lambda m: m.sgd(5e-2, momentum=0.9)),
    "sgd_clipped": (lambda m: m.sgd(5e-2, momentum=0.5, clip_norm=1.0)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(jx, name):
    """Three updates of one tree by each package's optimizer, with gradients
    large enough that clipping acts: params and every state entry agree."""
    from repro_torch.training import optimizer as port_opt
    opt, jopt = OPTIMIZERS[name](port_opt), OPTIMIZERS[name](jx.optimizer)
    tree = _tree(1)
    p, jp = _torch(tree), _jnp(jx, tree)
    st, jst = opt.init(p), jopt.init(jp)
    assert sorted(st) == sorted(jst)
    assert st["step"].dtype == torch.int32 and st["step"].shape == ()
    for i in range(3):
        grads = tree_map(lambda a: a * 3.0, _tree(10 + i))
        p, st = opt.update(p, _torch(grads), st)
        jp, jst = jopt.update(jp, _jnp(jx, grads), jst)
    _assert_trees_close(p, jp, OPT_RTOL, 1e-7)
    assert int(st["step"]) == int(jst["step"]) == 3
    for key in st:
        if key != "step":
            _assert_trees_close(st[key], jst[key], OPT_RTOL, 1e-7)


@pytest.mark.parametrize("kind", ["constant", "warmup_cosine"])
def test_schedules_match_jax(jx, kind):
    if kind == "constant":
        s, js = constant_schedule(3e-3), jx.optimizer.constant_schedule(3e-3)
    else:
        s = warmup_cosine_schedule(1.0, warmup=10, total=100, floor=0.2)
        js = jx.optimizer.warmup_cosine_schedule(1.0, warmup=10, total=100,
                                                 floor=0.2)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = float(s(torch.tensor(step, dtype=torch.int32)))
        want = float(js(jx.jnp.asarray(step, jx.jnp.int32)))
        np.testing.assert_allclose(got, want, rtol=OPT_RTOL)


def test_global_norm_and_clip_match_jax(jx):
    tree = tree_map(lambda a: a * 4.0, _tree(2))
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jx.optimizer.global_norm(_jnp(jx, tree))),
                               rtol=OPT_RTOL)
    got, g = clip_by_global_norm(_torch(tree), 1.0)
    want, jg = jx.optimizer.clip_by_global_norm(_jnp(jx, tree), 1.0)
    np.testing.assert_allclose(float(g), float(jg), rtol=OPT_RTOL)
    _assert_trees_close(got, want, OPT_RTOL, 1e-7)


# --------------------------------- tests/test_training.py, mirrored (port) --

def _quadratic_converges(opt, steps=300, tol=1e-2):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    st = opt.init(params)
    for _ in range(steps):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        params, st = opt.update(params, {"w": g}, st)
    loss = float(torch.sum((params["w"] - target) ** 2))
    assert loss < tol, loss


def test_adamw_converges():
    _quadratic_converges(adamw(3e-2))


def test_sgd_converges():
    _quadratic_converges(sgd(5e-2, momentum=0.9))


def test_adamw_mixed_precision_masters():
    """bf16 params keep fp32 masters: tiny updates must not be lost."""
    opt = adamw(1e-4, clip_norm=None)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    st = opt.init(params)
    for _ in range(50):
        g = {"w": torch.full((4,), 1e-3, dtype=torch.bfloat16)}
        params, st = opt.update(params, g, st)
    assert float(st["master"]["w"][0]) < 1.0
    assert params["w"].dtype == torch.bfloat16


def test_clip_by_global_norm():
    clipped, gn = clip_by_global_norm({"a": torch.full((10,), 10.0)}, 1.0)
    assert float(gn) > 1.0
    np.testing.assert_allclose(float(global_norm(clipped)), 1.0, rtol=1e-5)


def test_warmup_cosine_schedule():
    s = warmup_cosine_schedule(1.0, warmup=10, total=100)
    assert float(s(torch.tensor(0))) == 0.0
    np.testing.assert_allclose(float(s(torch.tensor(10))), 1.0, rtol=1e-6)
    assert float(s(torch.tensor(100))) < float(s(torch.tensor(50)))


def test_updates_mutate_nothing():
    """The optimizer's update builds new tensors: its inputs keep their
    values, and no new param aliases the state's master copy."""
    params = _torch(_tree(3))
    opt = adamw(1e-2)
    st = opt.init(params)
    before = [t.clone() for t in tree_leaves(params) + tree_leaves(st)]
    new_params, new_st = opt.update(params, _torch(_tree(4)), st)
    for b, a in zip(before, tree_leaves(params) + tree_leaves(st)):
        assert torch.equal(b, a)
    for p, m in zip(tree_leaves(new_params), tree_leaves(new_st["master"])):
        assert p.data_ptr() != m.data_ptr()


def test_checkpoint_atomic_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    params = {"w": torch.arange(4.0)}
    for step in (10, 20, 30):
        mgr.save(step, params)
    assert mgr.list_steps() == [20, 30]
    p2, _, step = mgr.restore({"w": torch.zeros(4)})
    assert step == 30
    torch.testing.assert_close(p2["w"], params["w"])


def test_checkpoint_restores_optimizer_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    opt = adamw(1e-2)
    params = {"w": torch.ones(3)}
    st = opt.init(params)
    params, st = opt.update(params, {"w": torch.ones(3)}, st)
    mgr.save(5, params, st)
    _, st2, _ = mgr.restore(params, st)
    assert int(st2["step"]) == 1 and st2["step"].dtype == torch.int32
    torch.testing.assert_close(st2["mu"]["w"], st["mu"]["w"])


def test_checkpoint_refuses_shardings(tmp_path):
    """Shardings place a restore on a mesh: without one (or a mesh without
    shardings) the restore is refused. Placing is
    ``tests/test_torch_sharding.py``'s, on gloo ranks."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(ValueError, match="shardings and a mesh"):
        mgr.restore({"w": torch.zeros(2)}, shardings={"w": None})
    with pytest.raises(ValueError, match="shardings and a mesh"):
        mgr.restore({"w": torch.zeros(2)}, mesh=object())


def test_retry_step_recovers():
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return x + 1

    assert FT.retry_step(flaky, 1, max_retries=3) == 2
    assert calls["n"] == 3


def test_retry_step_gives_up():
    def dead(_):
        raise RuntimeError("hard failure")
    with pytest.raises(FT.StepFailure):
        FT.retry_step(dead, 0, max_retries=2)


def test_straggler_monitor_flags_outliers():
    mon = FT.StragglerMonitor(threshold=2.0, warmup_steps=3)
    for i in range(10):
        mon.record(i, 0.1)
    assert mon.record(10, 0.5) is True
    assert mon.record(11, 0.1) is False


def test_elastic_mesh_planning():
    assert FT.plan_elastic_mesh(256, 16) == (16, 16)
    assert FT.plan_elastic_mesh(240, 16) == (8, 16)
    with pytest.raises(ValueError):
        FT.plan_elastic_mesh(8, 16)


def test_scale_batch_for_mesh():
    assert FT.scale_batch_for_mesh(256, 16, 8, keep_global=True) == 256
    assert FT.scale_batch_for_mesh(256, 16, 8, keep_global=False) == 128


# ------------------------------------------------------------- the trainer --

def _corpus():
    return QA.generate_corpus(n_docs=40, n_questions=20, seed=4)


def _stream(qa_mod, corpus, tok, max_len):
    ep = 0
    while True:
        yield from qa_mod.pair_batches(corpus, tok, max_len, 64, seed=ep)
        ep += 1


def _port_trainer(tree, device="cpu", **kw):
    cfg = _cfg()
    return Trainer(functools.partial(sm_cnn.loss_fn, cfg=cfg), adamw(3e-3),
                   sm_cnn.params_from_numpy(tree, device), **kw)


def _jax_trainer(jx, tree):
    return jx.train_loop.Trainer(functools.partial(jx.sm_cnn.loss_fn, cfg=jx.cfg),
                                 jx.optimizer.adamw(3e-3), _jnp(jx, tree))


def test_one_training_step_matches_jax(jx):
    cfg = _cfg()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    corpus, jcorpus = _corpus(), jx.qa.generate_corpus(n_docs=40, n_questions=20,
                                                       seed=4)
    tr, jtr = _port_trainer(tree), _jax_trainer(jx, tree)
    tr.run(_stream(QA, corpus, HashingTokenizer(cfg.vocab_size), cfg.max_len),
           max_steps=1, log_every=0)
    jtr.run(_stream(jx.qa, jcorpus, jx.Tok(jx.cfg.vocab_size), cfg.max_len),
            max_steps=1, log_every=0)
    _assert_trees_close(tr.params, jtr.params, STEP_RTOL, STEP_ATOL)
    for key in ("mu", "nu", "master"):
        _assert_trees_close(tr.opt_state[key], jtr.opt_state[key], STEP_RTOL,
                            STEP_ATOL)
    assert tr.step == jtr.step == 1
    for k in ("loss", "nll", "acc"):
        np.testing.assert_allclose(tr.history[0][k], jtr.history[0][k],
                                   rtol=STEP_RTOL)


@pytest.fixture(scope="module")
def trained(jx, tmp_path_factory):
    """Both packages trained 40 steps from one numpy tree on one stream;
    the port's trainer checkpoints every 20 steps."""
    cfg = _cfg()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    corpus, tok = _corpus(), HashingTokenizer(cfg.vocab_size)
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    tr = _port_trainer(tree, ckpt_dir=ckpt, ckpt_every=20)
    tr.run(_stream(QA, corpus, tok, cfg.max_len), max_steps=TRACE_STEPS,
           log_every=0)
    jcorpus = jx.qa.generate_corpus(n_docs=40, n_questions=20, seed=4)
    jtok = jx.Tok(jx.cfg.vocab_size)
    jtr = _jax_trainer(jx, tree)
    jtr.run(_stream(jx.qa, jcorpus, jtok, cfg.max_len), max_steps=TRACE_STEPS,
            log_every=0)
    docs = [tok.encode(" ".join(d)) for d in corpus.documents]
    return types.SimpleNamespace(
        cfg=cfg, corpus=corpus, tok=tok, index=BM.build_index(docs, cfg.vocab_size),
        jindex=jx.bm25.build_index(docs, cfg.vocab_size), jtok=jtok,
        tr=tr, jtr=jtr, ckpt=ckpt)


def test_loss_trace_matches_jax(trained):
    got = np.array([h["loss"] for h in trained.tr.history])
    want = np.array([h["loss"] for h in trained.jtr.history])
    assert len(got) == len(want) == TRACE_STEPS
    np.testing.assert_allclose(got, want, rtol=TRACE_RTOL)
    assert got[-1] < got[0] * 0.5          # it trained
    _assert_trees_close(trained.tr.params, trained.jtr.params, 1e-3, 1e-5)


def _ranking(stage_mod, scorer, index, corpus, tok, cfg, **kw):
    ranker = stage_mod.MultiStageRanker([
        stage_mod.RetrievalStage(index, corpus.documents, tok, h=8, **kw),
        stage_mod.RerankStage(scorer, tok, corpus.idf, cfg.max_len, k=5),
    ])
    return [[(c.doc_id, c.sent_id) for c in ranker.run(q)[0]]
            for q in corpus.questions[:5]]


@pytest.mark.parametrize("backend", ["eager", "pallas", "numpy"])
def test_trained_rankings_match_jax(jx, trained, backend):
    """test_system.py's claim across packages: the port's trained weights,
    served by each CPU backend, rank 5 questions' top 5 as JAX's trained
    weights served by ``jit`` do."""
    t = trained
    want = _ranking(jx.pipeline, jx.backends.make_scorer(
        "jit", t.jtr.params, jx.cfg, buckets=(64, 256, 1024)), t.jindex, t.corpus,
        t.jtok, t.cfg)
    got = _ranking(PL, BK.make_scorer(backend, t.tr.params, t.cfg,
                                      buckets=(64, 256, 1024), device="cpu"),
                   t.index, t.corpus, t.tok, t.cfg, device="cpu")
    assert got == want


def test_crash_resume_reproduces_state(trained):
    fresh = sm_cnn.init_sm_cnn(trained.cfg, torch.Generator().manual_seed(99), "cpu")
    tr2 = Trainer(functools.partial(sm_cnn.loss_fn, cfg=trained.cfg), adamw(3e-3),
                  fresh, ckpt_dir=trained.ckpt)
    assert tr2.restore() and tr2.step == TRACE_STEPS
    for a, b in zip(tree_leaves(tr2.params), tree_leaves(trained.tr.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tr2.opt_state), tree_leaves(trained.tr.opt_state)):
        assert torch.equal(a, b)


# -------------------------------------------------------------- max-pool ties --

def _tie_batch(cfg, seed=0):
    """Short questions (3 tokens of max_len 16): the windows past them
    gather ``embed[0]``, the PAD row, in their last four rows."""
    rng = np.random.default_rng(seed)
    q = np.zeros((4, cfg.max_len), np.int32)
    a = np.zeros((4, cfg.max_len), np.int32)
    q[:, :3] = rng.integers(1, cfg.vocab_size, (4, 3))
    a[:, :4] = rng.integers(1, cfg.vocab_size, (4, 4))
    return {"q_tok": q, "a_tok": a,
            "feats": rng.random((4, 4)).astype(np.float32),
            "label": np.array([0, 1, 1, 0], np.int32)}


def test_tied_pad_windows_split_gradients_as_jax(jx):
    """Filter 0 of ``conv_q`` is made positive, with its first window row
    zero: every window whose last four rows are PAD gives it the same
    value, its max, whatever the window's first row holds. So the max is
    tied over windows 6..15, and window 6's first row is a real token
    while the others' is PAD: a max that gave its gradient to one window
    would change the filter's gradient. ``amax`` splits it evenly, as
    ``jnp.max`` does."""
    cfg = _cfg()
    d, width = cfg.embed_dim, cfg.filter_width
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=2)
    tree["embed"][0] = 0.5
    tree["conv_q"]["w"][:, 0] = np.abs(tree["conv_q"]["w"][:, 0])
    tree["conv_q"]["w"][:d, 0] = 0.0
    batch = _tie_batch(cfg)
    params = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True),
                      tree)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    # the case is real: filter 0's max is taken at windows 6..15, window 6
    # (first row: the question's third token) among them
    cols = sm_cnn.im2col(params["embed"][tb["q_tok"].long()], width)
    h = torch.tanh(cols @ params["conv_q"]["w"] + params["conv_q"]["b"]).detach()
    at_max = (h == h.amax(dim=1, keepdim=True))[:, :, 0]
    assert at_max[:, 6:cfg.max_len].all() and at_max.sum() == 4 * (cfg.max_len - 6)

    loss, _ = sm_cnn.loss_fn(params, tb, cfg)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    jgrads = jx.jax.grad(lambda p: jx.sm_cnn.loss_fn(p, {
        k: jx.jnp.asarray(v) for k, v in batch.items()}, jx.cfg)[0])(_jnp(jx, tree))
    for g, jg in zip(grads, jx.jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)


# ----------------------------------------------------------------- checkpoints --

def _adamw_state_after_one_step(tree):
    p = _torch(tree)
    opt = adamw(1e-2)
    st = opt.init(p)
    return opt.update(p, _torch(tree_map(lambda a: a * 0.1, tree)), st)


def test_checkpoints_restore_across_packages(jx, tmp_path):
    """A JAX checkpoint restores in the port and the port's in JAX, params
    and optimizer state bit-equal; the params file of one tree is the same
    bytes from either package."""
    tree = sm_cnn.init_sm_cnn_numpy(_cfg(), seed=4)
    p, st = _adamw_state_after_one_step(tree)
    jp = _jnp(jx, tree_map(lambda t: t.numpy(), p))
    jst = jx.jax.tree.map(lambda t: jx.jnp.asarray(t.numpy()), st)

    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    CheckpointManager(port_dir).save(3, p, st)
    jx.checkpoint.CheckpointManager(jax_dir).save(3, jp, jst)
    for name in ("params.rpro", "opt.rpro"):
        with open(os.path.join(port_dir, "ckpt_0000000003", name), "rb") as f:
            port_bytes = f.read()
        with open(os.path.join(jax_dir, "ckpt_0000000003", name), "rb") as f:
            assert f.read() == port_bytes, name

    tp, tst, step = CheckpointManager(jax_dir).restore(
        tree_map(torch.zeros_like, p), tree_map(torch.zeros_like, st))
    assert step == 3 and tst["step"].dtype == torch.int32
    for a, b in zip(tree_leaves(tp) + tree_leaves(tst), tree_leaves(p) + tree_leaves(st)):
        assert torch.equal(a, b)
    jrp, jrst, _ = jx.checkpoint.CheckpointManager(port_dir).restore(
        jx.jax.tree.map(jx.jnp.zeros_like, jp), jx.jax.tree.map(jx.jnp.zeros_like, jst))
    for a, b in zip(jx.jax.tree.leaves((jrp, jrst)), tree_leaves(p) + tree_leaves(st)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_publish_checkpoint_ids_equal_across_packages(jx, tmp_path):
    tree = sm_cnn.init_sm_cnn_numpy(_cfg(), seed=6)
    CheckpointManager(str(tmp_path / "port")).save(
        9, sm_cnn.params_from_numpy(tree, "cpu"))
    jx.checkpoint.CheckpointManager(str(tmp_path / "jax")).save(9, _jnp(jx, tree))
    port_mv = CheckpointManager(str(tmp_path / "port")).publish_to_registry(
        ModelRegistry(str(tmp_path / "reg_port")))
    jax_mv = jx.registry.ModelRegistry(str(tmp_path / "reg_jax")).publish_checkpoint(
        jx.checkpoint.CheckpointManager(str(tmp_path / "jax")))
    assert port_mv.version_id == jax_mv.version_id
    assert port_mv.manifest["source_step"] == jax_mv.manifest["source_step"] == 9
    # a JAX checkpoint promoted by the port lands on the same id too
    assert ModelRegistry(str(tmp_path / "reg_x")).publish_checkpoint(
        jx.checkpoint.CheckpointManager(str(tmp_path / "jax"))).version_id \
        == jax_mv.version_id


def test_retry_step_leaves_params_unchanged_after_a_failed_step():
    """A step that raises after its update was computed commits nothing:
    the trainer's params are the values they were, and the retried step
    applies the update once, as a step that never failed does."""
    cfg = _cfg()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    batch = next(QA.pair_batches(_corpus(), HashingTokenizer(cfg.vocab_size),
                                 cfg.max_len, 64, seed=0))
    failing = _port_trainer(tree, max_retries=1)
    real_update = failing.optimizer.update
    calls = {"n": 0}

    def update_then_fail_once(params, grads, st):
        out = real_update(params, grads, st)
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("lost the step after its update")
        return out

    failing.optimizer = failing.optimizer._replace(update=update_then_fail_once)
    before = [t.clone() for t in tree_leaves(failing.params)]
    with pytest.raises(RuntimeError, match="lost the step"):
        failing._step(failing.params, failing.opt_state, batch)
    for b, a in zip(before, tree_leaves(failing.params)):
        assert torch.equal(b, a)
    assert int(failing.opt_state["step"]) == 0

    calls["n"] = 0
    failing.run(iter([batch]), log_every=0)
    clean = _port_trainer(tree)
    clean.run(iter([batch]), log_every=0)
    assert calls["n"] == 2 and int(failing.opt_state["step"]) == 1
    for a, b in zip(tree_leaves(failing.params), tree_leaves(clean.params)):
        assert torch.equal(a, b)


# ------------------------------------------------------- donated updates --

@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_donated_update_equals_the_functional_one_bit_for_bit(name, dtype):
    """Three updates with ``donate=True`` write the params, the state and
    the clipped grads in place (every tensor keeps its storage) and give the
    functional update's params and state to the bit, bfloat16 params (float32
    masters) too."""
    from repro_torch.training import optimizer as port_opt
    opt = OPTIMIZERS[name](port_opt)
    dt = getattr(torch, dtype)
    p_fn = tree_map(lambda t: t.to(dt), _torch(_tree(1)))
    p_in = tree_map(torch.clone, p_fn)
    st_fn, st_in = opt.init(p_fn), opt.init(p_in)
    ptrs = [t.data_ptr() for t in tree_leaves(p_in) + tree_leaves(st_in)]
    for i in range(3):
        grads = tree_map(lambda a: torch.from_numpy(a * 3.0).to(dt), _tree(10 + i))
        donated = tree_map(torch.clone, grads)
        p_fn, st_fn = opt.update(p_fn, grads, st_fn)
        p_in, st_in = opt.update(p_in, donated, st_in, donate=True)
    assert ptrs == [t.data_ptr() for t in tree_leaves(p_in) + tree_leaves(st_in)]
    assert sorted(st_in) == sorted(st_fn) and int(st_in["step"]) == 3
    for a, b in zip(tree_leaves(p_in) + tree_leaves(st_in),
                    tree_leaves(p_fn) + tree_leaves(st_fn)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_in_place_equals_the_functional_clip(dtype):
    from repro_torch.training.optimizer import clip_by_global_norm_
    dt = getattr(torch, dtype)
    tree = tree_map(lambda a: torch.from_numpy(a * 4.0).to(dt), _tree(2))
    want, wg = clip_by_global_norm(tree, 1.0)
    ptrs = [t.data_ptr() for t in tree_leaves(tree)]
    got, g = clip_by_global_norm_(tree, 1.0)
    assert got is tree and ptrs == [t.data_ptr() for t in tree_leaves(got)]
    assert torch.equal(g, wg)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_failing_donated_step_raises_step_failure_without_a_retry():
    """A donated step whose update raises after it began writing in place
    is not retried over the half-updated trees: ``run`` raises
    ``StepFailure`` at once (the update ran once, with retries left), as
    JAX's deleted buffers fail a retry; the trainer's step count stays."""
    cfg = _cfg()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    batch = next(QA.pair_batches(_corpus(), HashingTokenizer(cfg.vocab_size),
                                 cfg.max_len, 64, seed=0))
    tr = _port_trainer(tree, donate=True, max_retries=2)
    real_update = tr.optimizer.update
    calls = {"n": 0}

    def update_then_fail(params, grads, st, donate=False):
        calls["n"] += 1
        real_update(params, grads, st, donate=donate)
        raise RuntimeError("lost the step after its update")

    tr.optimizer = tr.optimizer._replace(update=update_then_fail)
    with pytest.raises(FT.StepFailure) as failed:
        tr.run(iter([batch]), log_every=0)
    assert isinstance(failed.value.__cause__, RuntimeError)
    assert calls["n"] == 1 and tr.step == 0
    assert int(tr.opt_state["step"]) == 1   # the update had begun in place


def test_a_donated_step_that_fails_before_its_update_is_retried():
    """A failure before the donated update (here in the loss) has written
    nothing, so ``retry_step`` runs the step again, and the trainer ends
    where a donated trainer that never failed does, to the bit."""
    cfg = _cfg()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    batch = next(QA.pair_batches(_corpus(), HashingTokenizer(cfg.vocab_size),
                                 cfg.max_len, 64, seed=0))
    calls = {"n": 0}

    def loss_failing_once(params, b):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("lost the forward")
        return sm_cnn.loss_fn(params, b, cfg=cfg)

    failing = Trainer(loss_failing_once, adamw(3e-3), sm_cnn.params_from_numpy(tree, "cpu"),
                      donate=True, max_retries=1)
    failing.run(iter([batch]), log_every=0)
    clean = _port_trainer(tree, donate=True)
    clean.run(iter([batch]), log_every=0)
    assert calls["n"] == 2 and failing.step == clean.step == 1
    for a, b in zip(tree_leaves(failing.params) + tree_leaves(failing.opt_state),
                    tree_leaves(clean.params) + tree_leaves(clean.opt_state)):
        assert torch.equal(a, b)


def test_donated_trainer_equals_the_functional_one():
    """Five ``Trainer`` steps on sm-cnn with ``donate`` True and False: the
    same losses, params and state, bit for bit."""
    cfg = _cfg()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    trainers = [_port_trainer(tree, donate=d) for d in (False, True)]
    for tr in trainers:
        tr.run(_stream(QA, _corpus(), HashingTokenizer(cfg.vocab_size), cfg.max_len),
               max_steps=5, log_every=0)
    fn, kept = trainers
    assert [h["loss"] for h in fn.history] == [h["loss"] for h in kept.history]
    for a, b in zip(tree_leaves(fn.params) + tree_leaves(fn.opt_state),
                    tree_leaves(kept.params) + tree_leaves(kept.opt_state)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Trainer on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_trainer_matches_the_cpu(cuda_device):
    """Ten steps on the card against ten on the CPU from one tree: losses
    within 1e-4 relative (the card's embedding backward accumulates with
    atomics, so not bit-equal), the params on the card, the loss falling."""
    cfg = _cfg()
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    corpus, tok = _corpus(), HashingTokenizer(cfg.vocab_size)
    cpu, card = _port_trainer(tree), _port_trainer(tree, device=cuda_device)
    cpu.run(_stream(QA, corpus, tok, cfg.max_len), max_steps=10, log_every=0)
    card.run(_stream(QA, corpus, tok, cfg.max_len), max_steps=10, log_every=0)
    assert all(t.device.type == "cuda" for t in tree_leaves(card.params))
    assert card.opt_state["step"].device.type == "cuda"
    np.testing.assert_allclose([h["loss"] for h in card.history],
                               [h["loss"] for h in cpu.history], rtol=1e-4)
    assert card.history[-1]["loss"] < card.history[0]["loss"]
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
