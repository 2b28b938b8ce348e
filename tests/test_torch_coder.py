"""deepseek-coder-33b in the port against the JAX package: its config, and
its serving and training paths on a coder-shaped small config.

deepseek-coder-33b is the one assigned config whose group size G = H / Hkv
is not a power of two (56 query heads over 8 KV heads: G=7), with an untied
head (``lm_head``), no qk_norm and ``rope_theta`` 1e5 (llama-arch). The
small config keeps every one of those traits at d_model 256 over 2 layers:
H=14 over Hkv=2 (G=7), d_head 32, d_ff 512, the full vocabulary of 32,256,
float32. JAX parameters come from ``repro.models.transformer.init_lm`` and
reach the port through ``params_from_numpy``; tokens come from numpy.
Everything runs on the CPU, where the attention wrapper runs its plain
version, at ``tests/test_torch_lm.py``'s tolerance (``rtol=1e-4,
atol=1e-5``): ``forward``, ``prefill`` (logits and cache) and
``decode_step`` on the unquantized cache (the model's dtype: bfloat16 when
serving, float32 here) and on the int8 one (``kv_quant``), whose
quantized rows may sit one int8 step off JAX's where the two sides' float32
K/V differ in their last bit (``tests/test_torch_kv_int8.py``'s bound);
``loss_fn`` and every gradient leaf against ``jax.value_and_grad`` with
remat on and off (the attention's gradient through ``FlashAttention``'s
plain backward at G=7), and three ``Trainer`` + ``adamw`` steps against the
JAX ``Trainer``'s (``tests/test_torch_granite_train.py``'s comparison).

The ``cuda``-marked test holds a gradient at G=7 on the card: the forward
and backward kernels launch once each, and the gradients match the plain
backward's. It skips where no card is present; the JAX side is imported by
a fixture, so that it runs on a machine with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_coder.py

The card side of the forward and backward at G=7 is in
``tests/test_torch_flash.py``'s and ``tests/test_torch_flash_bwd.py``'s
``cuda`` tests and ``chip_smoke.py``'s attn-g7, attn-bwd, lm-coder-check,
lm-coder and lm-coder-train phases.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import export
from repro_torch.core.treepath import tree_map
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import Trainer

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "deepseek-coder-33b"
SMALL = dict(name="deepseek-coder-33b-small", n_layers=2, d_model=256, n_heads=14,
             n_kv_heads=2, d_head=32, d_ff=512, dtype="float32", remat=False,
             attn_chunk=16)
#: of the int8 values a decode step writes, the share that may be one step
#: off JAX's (tests/test_torch_kv_int8.py's)
OFF_BY_ONE_SHARE = 0.01
#: the training tests' batch: S a multiple of attn_chunk (16)
TRAIN_B, TRAIN_S = 2, 32


@pytest.fixture(scope="module")
def J():
    """The JAX package's side of the comparison, and its small model's
    weights with the port's copy of them (``params_from_numpy``)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.core import export as jax_export
    from repro.models import transformer as jax_tfm
    jcfg = dataclasses.replace(jax_get_config(ARCH), **SMALL)
    jp = jax_tfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return types.SimpleNamespace(jax=jax, jnp=jnp, tfm=jax_tfm, export=jax_export,
                                 get_config=jax_get_config, cfg=jcfg, params=jp,
                                 tparams=tp)


def _cfg(**kw):
    return dataclasses.replace(get_config(ARCH), **dict(SMALL, **kw))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tokens(cfg, b=2, s=12, seed=1):
    # ids across the whole vocabulary, the last rows of the table included
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_matches_jax(J):
    jcfg, cfg = J.get_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
            cfg.vocab_size, cfg.tie_embeddings, cfg.qk_norm, cfg.rope_theta, cfg.moe) == (
        62, 7168, 56, 8, 128, 19200, 32256, False, False, 1e5, None)
    assert cfg.n_heads // cfg.n_kv_heads == 7
    assert cfg.vocab_padded == jcfg.vocab_padded == 32256
    assert cfg.n_params() == jcfg.n_params() == 33_342_095_360
    assert cfg.n_active_params() == jcfg.n_active_params()


def test_small_config_keeps_coders_traits(J):
    cfg = _cfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(J.cfg)
    assert cfg.n_heads // cfg.n_kv_heads == 7 and cfg.n_heads % cfg.n_kv_heads == 0
    assert (cfg.tie_embeddings, cfg.qk_norm, cfg.rope_theta, cfg.attn_impl) == (
        False, False, 1e5, "flash")


def test_params_from_numpy_match_jax_init_lm(J):
    """The JAX tree through ``params_from_numpy``: the same names, shapes,
    dtypes and values; the port's own ``init_lm`` builds the same tree,
    an untied ``lm_head`` in it, at JAX's scales."""
    jflat = J.export._flatten_named(J.jax.tree.map(np.asarray, J.params))
    tflat = export.flatten_named(J.tparams)
    assert sorted(tflat) == sorted(jflat)
    for name, arr in tflat.items():
        np.testing.assert_array_equal(arr, jflat[name], err_msg=name)
    flat = export.flatten_named(tfm.init_lm(_cfg(), torch.Generator().manual_seed(0), "cpu"))
    assert sorted(flat) == sorted(jflat)
    for name, arr in flat.items():
        assert arr.shape == jflat[name].shape and arr.dtype == jflat[name].dtype, name
    assert flat["lm_head"].shape == (256, 32256) and flat["embed"].shape == (32256, 256)
    assert flat["layers/attn/wq"].shape == (2, 256, 14 * 32)
    assert flat["layers/attn/wk"].shape == (2, 256, 2 * 32)
    scales = (("embed", 0.02), ("lm_head", 256 ** -0.5), ("layers/attn/wq", 256 ** -0.5),
              ("layers/attn/wo", 448 ** -0.5), ("layers/mlp/w_down", 512 ** -0.5))
    for name, std in scales:
        assert abs(float(flat[name].std()) / std - 1) < 0.05, name
        assert abs(float(np.std(jflat[name])) / std - 1) < 0.05, name


def test_forward_and_prefill_match_jax(J):
    cfg = _cfg()
    toks = _tokens(cfg)
    want, _ = J.tfm.forward(J.params, J.jnp.asarray(toks), J.cfg)
    got, aux = tfm.forward(J.tparams, _t(toks), cfg)
    assert tuple(got.shape) == (2, 12, 32256) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    jl, jc = J.tfm.prefill(J.params, J.jnp.asarray(toks), J.cfg)
    tl, tc = tfm.prefill(J.tparams, _t(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape == (2, 2, 12, 2, 32)
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), **TOL)


def test_decode_step_on_the_cache_matches_jax(J):
    """One step at positions 12 (row 0) and 9 (row 1) on a 16-slot cache
    after JAX's prefill, then a second step at the next positions."""
    cfg = _cfg()
    toks = _tokens(cfg)
    _, jc = J.tfm.prefill(J.params, J.jnp.asarray(toks), J.cfg)
    jcache = J.tfm.init_cache(J.cfg, 2, 16)
    jcache = {k: v.at[:, :, :12].set(jc[k]) for k, v in jcache.items()}
    tcache = tfm.init_cache(cfg, 2, 16, device="cpu")
    for key in ("k", "v"):
        tcache[key][:, :, :12] = _t(np.asarray(jc[key]))
    pos = np.array([12, 9], np.int32)
    for new in (np.array([3, 32255], np.int32), np.array([17, 0], np.int32)):
        jl, jcache = J.tfm.decode_step(J.params, jcache, J.jnp.asarray(new),
                                       J.jnp.asarray(pos), J.cfg)
        tl, tcache = tfm.decode_step(J.tparams, tcache, _t(new), _t(pos), cfg)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tcache[key].numpy(), _np(jcache[key]), **TOL)
        pos = pos + 1


def test_decode_step_on_the_int8_cache_matches_jax(J):
    """kv_quant: JAX's prefill cache quantized by each package's own
    ``_kv_quantize`` (equal bit for bit), then two steps: the logits at
    TOL, every cache entry the steps do not write equal, the written int8
    rows at most one step off and their scales at TOL."""
    jcfg = dataclasses.replace(J.cfg, kv_quant=True)
    cfg = _cfg(kv_quant=True)
    toks = _tokens(cfg, seed=4)
    _, jc = J.tfm.prefill(J.params, J.jnp.asarray(toks), jcfg)
    jcache = J.tfm.init_cache(jcfg, 2, 16)
    tcache = tfm.init_cache(cfg, 2, 16, device="cpu")
    for key in ("k", "v"):
        jq, jscale = J.tfm._kv_quantize(jc[key])
        q, scale = tfm._kv_quantize(_t(np.asarray(jc[key])))
        jcache[key] = jcache[key].at[:, :, :12].set(jq)
        jcache[f"{key}_scale"] = jcache[f"{key}_scale"].at[:, :, :12].set(jscale)
        tcache[key][:, :, :12] = q
        tcache[f"{key}_scale"][:, :, :12] = scale
    for key in tcache:
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))
    assert tcache["k"].dtype == torch.int8
    pos = np.array([12, 9], np.int32)
    written = np.zeros(tcache["k_scale"].shape, bool)
    for new in (np.array([5, 32000], np.int32), np.array([1, 2], np.int32)):
        jl, jcache = J.tfm.decode_step(J.params, jcache, J.jnp.asarray(new),
                                       J.jnp.asarray(pos), jcfg)
        tl, tcache = tfm.decode_step(J.tparams, tcache, _t(new), _t(pos), cfg)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        written[:, [0, 1], pos] = True
        pos = pos + 1
    off = total = 0
    for key in ("k", "v"):
        got, want = tcache[key].numpy(), np.asarray(jcache[key])
        np.testing.assert_array_equal(got[~written], want[~written])
        diff = np.abs(got[written].astype(np.int32) - want[written].astype(np.int32))
        assert diff.max() <= 1, key
        off, total = off + int((diff == 1).sum()), total + diff.size
        sgot, swant = tcache[f"{key}_scale"].numpy(), np.asarray(jcache[f"{key}_scale"])
        np.testing.assert_array_equal(sgot[~written], swant[~written])
        np.testing.assert_allclose(sgot[written], swant[written], **TOL)
    assert off <= OFF_BY_ONE_SHARE * total, f"{off} of {total} int8 values one step off"


def test_flash_matches_chunked_at_g7_without_a_launch(J):
    cfg = _cfg()
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    before = FA.launches
    for s in (12, 32):   # one chunk of 16 and two
        toks = _t(_tokens(cfg, s=s, seed=2))
        np.testing.assert_allclose(tfm.forward(J.tparams, toks, cfg)[0].numpy(),
                                   tfm.forward(J.tparams, toks, chunked)[0].numpy(), **TOL)
        fl, fc = tfm.prefill(J.tparams, toks, cfg)
        cl, cc = tfm.prefill(J.tparams, toks, chunked)
        np.testing.assert_allclose(fl.numpy(), cl.numpy(), **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(fc[key].numpy(), cc[key].numpy(), **TOL)
    assert FA.launches == before   # CPU tensors: the plain version, no launch


def test_decode_steps_from_an_empty_cache_match_forward(J):
    cfg = _cfg()
    toks = _tokens(cfg, s=8, seed=3)
    full, _ = tfm.forward(J.tparams, _t(toks), cfg)
    cache = tfm.init_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        lg, cache = tfm.decode_step(J.tparams, cache, _t(toks[:, t]),
                                    torch.full((2,), t, dtype=torch.int32), cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), **TOL)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _train_cfgs(J, remat):
    return dataclasses.replace(J.cfg, remat=remat), _cfg(remat=remat)


def _train_batch(cfg, seed=3):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                (TRAIN_B, TRAIN_S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_leaf_match_jax_grad_at_g7(J, remat):
    """``loss_fn`` and d loss / d leaf for every leaf (the untied
    ``lm_head`` among them) against ``jax.value_and_grad`` of the JAX
    ``loss_fn``, with remat on and off in both packages; on the CPU the
    attention runs ``FlashAttention``'s plain forward and backward at G=7.
    Every leaf's gradient is nonzero; nothing launches."""
    jcfg, cfg = _train_cfgs(J, remat)
    batch = _train_batch(cfg)
    (want, want_m), want_g = J.jax.jit(J.jax.value_and_grad(
        functools.partial(J.tfm.loss_fn, cfg=jcfg), has_aux=True))(
        J.params, {k: J.jnp.asarray(v) for k, v in batch.items()})
    live = tree_map(lambda t: t.detach().clone().requires_grad_(True), J.tparams)
    before = (FA.launches, FA.bwd_launches)
    loss, metrics = tfm.loss_fn(live, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    leaves = _flat(live)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert (FA.launches, FA.bwd_launches) == before
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(metrics["ce"].item(), float(want_m["ce"]), rtol=1e-5)
    want_flat = _flat(want_g)
    assert set(grads) == set(want_flat) and "lm_head" in grads
    for path, g in grads.items():
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), _np(want_flat[path]), err_msg=path, **TOL)


def test_three_trainer_steps_match_jax_at_g7(J):
    """Three ``Trainer`` + ``adamw`` steps (the launcher's warmup-cosine
    schedule, clipping at 1.0; remat on, updates donated as the launcher's
    ``--full`` runs them) against the JAX ``Trainer``'s: each step's loss at
    rtol 1e-5 and every leaf after the third step at TOL."""
    from repro.training import optimizer as jax_opt, train_loop as jax_train_loop
    jcfg, cfg = _train_cfgs(J, True)
    batches = [_train_batch(cfg, seed=10 + i) for i in range(3)]
    sched = dict(peak_lr=1e-3, warmup=10, total=30)
    jtr = jax_train_loop.Trainer(functools.partial(J.tfm.loss_fn, cfg=jcfg),
                                 jax_opt.adamw(jax_opt.warmup_cosine_schedule(**sched)),
                                 J.params)
    jtr.run(iter(batches), max_steps=3, log_every=0)
    tr = Trainer(functools.partial(tfm.loss_fn, cfg=cfg),
                 opt.adamw(opt.warmup_cosine_schedule(**sched)),
                 tree_map(lambda t: t.detach().clone(), J.tparams), donate=True)
    tr.run(iter(batches), max_steps=3, log_every=0)
    assert tr.step == jtr.step == 3
    for got, want in zip(tr.history, jtr.history):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    want = _flat(J.jax.tree.map(np.asarray, jtr.params))
    for path, leaf in _flat(tr.params).items():
        np.testing.assert_allclose(_np(leaf.detach()), want[path], err_msg=path, **TOL)


@pytest.mark.cuda
def test_cuda_gradient_at_g7_is_refused_before_any_launch():
    """G=7, which the backward once refused before any launch (the name is
    kept): a call that needs the gradient launches the forward and the
    backward kernel once each, and its gradients match the plain
    backward's; the forward alone launches once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(0)
    q, k, v = (torch.randn((1, 64, n, 128), generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_() for n in (56, 8, 8))
    dout = torch.randn((1, 64, 56, 128), generator=gen, device="cuda", dtype=torch.bfloat16)
    before = (FA.launches, FA.bwd_launches)
    out = FA.flash_attention(q, k, v)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (FA.launches, FA.bwd_launches) == (before[0] + 1, before[1] + 1)
    _, lse = FA.flash_attention_fwd_plain(q.detach(), k.detach(), v.detach())
    want = FA.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                        lse, dout)
    for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2, atol=2e-2,
                                   msg=lambda m: f"d{name}: {m}")
    with torch.no_grad():
        out = FA.flash_attention(q, k, v)   # the forward alone launches
    torch.cuda.synchronize()
    assert (FA.launches, FA.bwd_launches) == (before[0] + 2, before[1] + 1)
    assert bool(torch.isfinite(out).all())
