"""granite-3-2b's training path in the port against the JAX package, with
its layers rematerialised (``cfg.remat``) and the ``Trainer``'s donated
update.

A granite-shaped small config keeps granite's traits at d_model 256 over 2
layers: d_head 64, H=8 over Hkv=2 (G=4), tied embeddings, the full
vocabulary of 49,155 padded to 49,280, float32. On the CPU the attention
wrapper runs its plain version both ways (``FlashAttention``'s CPU
forward and backward), so these tests hold the model around the kernels:

* ``remat=True`` against ``remat=False`` in the port, bit for bit (the loss
  and every gradient leaf), with each layer run twice under remat;
* the port with ``remat=True`` against ``jax.value_and_grad`` of the JAX
  ``loss_fn`` with ``remat=True`` (``jax.checkpoint``), at
  ``tests/test_torch_lm_train.py``'s tolerances;
* three ``Trainer`` + ``adamw`` steps against the JAX ``Trainer``'s, with
  ``donate`` True and False giving equal values to the bit.

JAX parameters come from ``repro.models.transformer.init_lm`` and reach the
port through ``params_from_numpy``; tokens come from numpy seeds. The card
side (the bfloat16 kernels at d=64 both ways, granite at full width and
depth) is in ``tests/test_torch_flash_bwd.py``'s ``cuda`` tests and
``chip_smoke.py``'s attn-bwd and lm-granite-train phases.

  PYTHONPATH=src python -m pytest -q tests/test_torch_granite_train.py
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import transformer as jax_tfm
from repro.training import optimizer as jax_opt, train_loop as jax_train_loop
from repro_torch.configs import get_config
from repro_torch.core.treepath import tree_leaves, tree_map
from repro_torch.models import transformer as tfm
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import Trainer

torch.set_num_threads(2)
ARCH = "granite-3-2b"
SMALL = dict(name="granite-3-2b-small", n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
             d_head=64, d_ff=512, dtype="float32", attn_chunk=16)
#: tests/test_torch_lm_train.py's: float32 sums in another order through two
#: layers
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 32     # S a multiple of attn_chunk (16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(attn_impl="flash", remat=True):
    over = dict(SMALL, attn_impl=attn_impl, remat=remat)
    return (dataclasses.replace(jax_get_config(ARCH), **over),
            dataclasses.replace(get_config(ARCH), **over))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jcfg, _ = _cfgs()
    return jax_tfm.init_lm(jax.random.PRNGKey(0), jcfg)


def _port_params():
    return tfm.params_from_numpy(jax.tree.map(np.asarray, _jax_params()), "cpu")


def _batch(cfg, seed=3):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _loss_and_grads(cfg, batch):
    live = tree_map(lambda p: p.requires_grad_(True), _port_params())
    loss, metrics = tfm.loss_fn(live, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    leaves = _flat(live)
    return loss, metrics, dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


@pytest.mark.parametrize("attn_impl", ["flash", "chunked"])
def test_remat_gives_the_same_loss_and_gradients_bit_for_bit(attn_impl, monkeypatch):
    """Remat runs each layer again in the backward (2 L block calls for a
    loss and its gradient, L without) and changes no value: the loss and
    every leaf's gradient are bit-equal with it on and off."""
    calls = {"n": 0}
    block = tfm._block

    def counted(*args):
        calls["n"] += 1
        return block(*args)

    monkeypatch.setattr(tfm, "_block", counted)
    results = {}
    for remat in (True, False):
        _, cfg = _cfgs(attn_impl, remat)
        calls["n"] = 0
        results[remat] = _loss_and_grads(cfg, _batch(cfg))
        assert calls["n"] == (2 if remat else 1) * cfg.n_layers, (remat, calls["n"])
    (loss_on, _, on), (loss_off, _, off) = results[True], results[False]
    assert torch.equal(loss_on, loss_off)
    assert set(on) == set(off)
    for path in on:
        assert torch.equal(on[path], off[path]), path


def test_remat_applies_only_where_grad_is_enabled(monkeypatch):
    """Under ``inference_mode`` (serving, ``prefill``) no layer is
    checkpointed: each runs once."""
    calls = {"n": 0}
    block = tfm._block

    def counted(*args):
        calls["n"] += 1
        return block(*args)

    monkeypatch.setattr(tfm, "_block", counted)
    _, cfg = _cfgs("flash", True)
    toks = torch.from_numpy(_batch(cfg)["tokens"])
    with torch.inference_mode():
        logits, _ = tfm.forward(_port_params(), toks, cfg)
        tfm.prefill(_port_params(), toks, cfg)
    assert calls["n"] == 2 * cfg.n_layers
    assert tuple(logits.shape) == (B, S, cfg.vocab_padded)


@pytest.mark.parametrize("attn_impl", ["flash", "chunked"])
def test_remat_loss_and_every_gradient_leaf_match_jax_remat(attn_impl):
    """The port's ``loss_fn`` with ``remat=True`` and d loss / d leaf for all
    leaves against ``jax.value_and_grad`` of the JAX ``loss_fn`` with
    ``remat=True``; every leaf nonzero, no ``lm_head``."""
    jcfg, cfg = _cfgs(attn_impl, True)
    batch = _batch(cfg)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        functools.partial(jax_tfm.loss_fn, cfg=jcfg), has_aux=True))(
        _jax_params(), {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_m, grads = _loss_and_grads(cfg, batch)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["ce"].item(), float(want_m["ce"]), rtol=1e-5)
    want_flat = _flat(want_g)
    assert set(grads) == set(want_flat) and "lm_head" not in grads
    for path, g in grads.items():
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), _np(want_flat[path]), err_msg=path, **GRAD_TOL)


def test_three_trainer_steps_match_jax_donated_or_not():
    """Three ``Trainer`` steps with ``adamw`` (the launcher's warmup-cosine
    schedule, clipping at 1.0) against the JAX ``Trainer``'s (remat on in
    both): each step's loss at rtol 1e-5 and every leaf after the third
    step at GRAD_TOL. ``donate=True`` updates the port's params and state in
    place (each tensor keeps its storage) and gives ``donate=False``'s
    values to the bit."""
    jcfg, cfg = _cfgs("flash", True)
    batches = [_batch(cfg, seed=10 + i) for i in range(3)]
    sched = dict(peak_lr=1e-3, warmup=10, total=30)
    jtr = jax_train_loop.Trainer(functools.partial(jax_tfm.loss_fn, cfg=jcfg),
                                 jax_opt.adamw(jax_opt.warmup_cosine_schedule(**sched)),
                                 _jax_params())
    jtr.run(iter(batches), max_steps=3, log_every=0)
    trainers = {}
    for donate in (False, True):
        tr = Trainer(functools.partial(tfm.loss_fn, cfg=cfg),
                     opt.adamw(opt.warmup_cosine_schedule(**sched)), _port_params(),
                     donate=donate)
        ptrs = [t.data_ptr() for t in tree_leaves(tr.params) + tree_leaves(tr.opt_state)]
        tr.run(iter(batches), max_steps=3, log_every=0)
        if donate:   # every tensor written in place
            assert ptrs == [t.data_ptr() for t in tree_leaves(tr.params)
                            + tree_leaves(tr.opt_state)]
        trainers[donate] = tr
    for donate, tr in trainers.items():
        assert tr.step == jtr.step == 3
        for got, want in zip(tr.history, jtr.history):
            np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        want = _flat(jax.tree.map(np.asarray, jtr.params))
        for path, leaf in _flat(tr.params).items():
            np.testing.assert_allclose(_np(leaf), want[path], err_msg=path, **GRAD_TOL)
    kept, functional = trainers[True], trainers[False]
    for a, b in zip(tree_leaves(kept.params) + tree_leaves(kept.opt_state),
                    tree_leaves(functional.params) + tree_leaves(functional.opt_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [h["loss"] for h in kept.history] == [h["loss"] for h in functional.history]
