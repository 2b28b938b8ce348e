"""The port's LM training path against ``repro.models.transformer`` and
``repro.models.layers`` on the same inputs and weights.

``layers.cross_entropy`` (with and without z-loss) and its gradient;
``transformer.loss_fn``'s value and the gradient of EVERY parameter leaf
against ``jax.value_and_grad`` of the JAX ``loss_fn`` on reduced
``qwen3-0.6b`` in float32, with ``attn_impl`` "flash" (the attention
module's ``FlashAttention``, whose CPU backward is the plain port of
``flash_attention_jnp``'s custom VJP) and "chunked" (plain autograd), each
leaf's gradient also nonzero: a leaf the loss does not reach would get a
zero gradient from a trainer that fills in ``None``s, and train silently
wrong; then three ``make_train_step`` steps with ``adamw`` against the JAX
package's.

Inputs are made with numpy from a seed; JAX parameters come from
``repro.models.transformer.init_lm`` and reach the port through
``params_from_numpy``. Everything runs in float32 on the CPU; tolerances are
stated beside each comparison.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.models import layers as jax_layers, transformer as jax_tfm
from repro.training import optimizer as jax_opt
from repro_torch.configs import get_config, reduced
from repro_torch.core.treepath import tree_leaves, tree_map
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers, transformer as tfm
from repro_torch.training import optimizer as opt

torch.set_num_threads(2)
#: the loss and the gradients: float32 sums in another order through two
#: layers (test_layers.py holds the custom VJP to autodiff at 1e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 32     # S a multiple of the reduced config's attn_chunk (16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _cfgs(attn_impl="flash", vocab=None):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen3-0.6b")),
                               remat=False, attn_impl=attn_impl)
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")), attn_impl=attn_impl)
    if vocab is not None:   # 250 pads to 256: the padded-vocab mask runs
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _jax_params(vocab):
    jcfg, _ = _cfgs(vocab=vocab)
    return jax_tfm.init_lm(jax.random.PRNGKey(0), jcfg)


def _port_params(vocab):
    return tfm.params_from_numpy(jax.tree.map(np.asarray, _jax_params(vocab)), "cpu")


def _batch(vocab, seed=3):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (the JAX package's and the port's
    trees have the same nesting)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ----------------------------------------------------------- cross-entropy --

@pytest.mark.parametrize("z_loss", [0.0, 1e-4, 0.1])
def test_cross_entropy_matches_jax(z_loss):
    """Value and gradient with respect to the logits, at rtol 1e-6 / 1e-5:
    logits of std 3 over 97 classes, labels from a seed."""
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((3, 7, 97))).astype(np.float32)
    labels = rng.integers(0, 97, (3, 7)).astype(np.int32)
    want, want_g = jax.value_and_grad(
        lambda x: jax_layers.cross_entropy(x, jnp.asarray(labels), z_loss=z_loss))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = layers.cross_entropy(x, torch.from_numpy(labels), z_loss=z_loss)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)


def test_cross_entropy_in_float32_from_bfloat16_logits():
    """bfloat16 logits are summed in float32, as the JAX function casts."""
    rng = np.random.default_rng(6)
    logits = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    labels = rng.integers(0, 64, (2, 5)).astype(np.int32)
    want = jax_layers.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                                    jnp.asarray(labels), z_loss=1e-4)
    got = layers.cross_entropy(torch.from_numpy(logits).to(torch.bfloat16),
                               torch.from_numpy(labels), z_loss=1e-4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ----------------------------------------------------------------- loss_fn --

@pytest.mark.parametrize("attn_impl,vocab", [("flash", 256), ("chunked", 256),
                                             ("flash", 250)])
def test_loss_and_every_gradient_leaf_match_jax(attn_impl, vocab):
    """``loss_fn`` and d loss / d leaf for all leaves (embedding, the final
    norm and each layer's wq, wk, wv, wo, q_norm, k_norm, norms and MLP)
    against ``jax.value_and_grad``; every leaf's gradient is nonzero."""
    jcfg, cfg = _cfgs(attn_impl, vocab)
    batch = _batch(vocab)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        functools.partial(jax_tfm.loss_fn, cfg=jcfg), has_aux=True))(
        _jax_params(vocab), {k: jnp.asarray(v) for k, v in batch.items()})
    live = tree_map(lambda p: p.requires_grad_(True), _port_params(vocab))
    before = FA.bwd_launches
    got, got_m = tfm.loss_fn(live, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    leaves = _flat(live)
    grads = dict(zip(leaves, torch.autograd.grad(got, list(leaves.values()))))
    assert FA.bwd_launches == before    # the CPU backward launches nothing
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_m["ce"].item(), float(want_m["ce"]), rtol=1e-5)
    assert got_m["moe_aux"].item() == 0.0 == float(want_m["moe_aux"])
    want_flat = _flat(want_g)
    assert set(grads) == set(want_flat)
    for path, g in grads.items():
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), _np(want_flat[path]), err_msg=path, **GRAD_TOL)


def test_flash_training_goes_through_the_attention_function():
    """Under grad, each layer's attention is a ``FlashAttention`` node of the
    graph: its backward is the attention module's, not autograd of a plain
    forward."""
    _, cfg = _cfgs("flash")
    params = tree_map(lambda p: p.requires_grad_(True), _port_params(256))
    loss, _ = tfm.loss_fn(params, {k: torch.from_numpy(v) for k, v in _batch(256).items()},
                          cfg)
    seen, stack, n = set(), [loss.grad_fn], 0
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        n += type(fn).__name__ == "FlashAttentionBackward"
        stack.extend(f for f, _ in fn.next_functions)
    assert n == cfg.n_layers


# --------------------------------------------------------- make_train_step --

def test_three_train_steps_match_jax():
    """Three ``make_train_step`` steps with ``adamw`` (warmup-cosine, the
    launcher's) against the JAX package's: each step's metrics and every
    leaf after the third step, at rtol 1e-4 / atol 1e-5 (adam normalises
    the gradient, so an update moves each weight by about lr)."""
    jcfg, cfg = _cfgs("flash")
    jstep = jax.jit(jax_tfm.make_train_step(jcfg, jax_opt.adamw(
        jax_opt.warmup_cosine_schedule(1e-3, 10, 30))))
    step = tfm.make_train_step(cfg, opt.adamw(opt.warmup_cosine_schedule(1e-3, 10, 30)))
    jp = _jax_params(256)
    js = jax_opt.adamw(1e-3).init(jp)
    p = _port_params(256)
    st = opt.adamw(1e-3).init(p)
    for i in range(3):
        batch = _batch(256, seed=10 + i)
        jp, js, jm = jstep(jp, js, {k: jnp.asarray(v) for k, v in batch.items()})
        p, st, m = step(p, st, {k: torch.from_numpy(v) for k, v in batch.items()})
        for key in ("loss", "ce", "moe_aux"):
            np.testing.assert_allclose(m[key].item(), float(jm[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    want = _flat(jax.tree.map(np.asarray, jp))
    for path, leaf in _flat(p).items():
        np.testing.assert_allclose(_np(leaf), want[path], err_msg=path, **GRAD_TOL)
    assert int(st["step"]) == 3


def test_train_step_refuses_a_leaf_the_loss_does_not_reach():
    """No zero-fill: a leaf with no path to the loss is an error, not a
    silently frozen weight."""
    _, cfg = _cfgs("flash")
    params = dict(_port_params(256), stray=torch.ones(3))
    step = tfm.make_train_step(cfg, opt.adamw(1e-3))
    with pytest.raises(RuntimeError):
        step(params, opt.adamw(1e-3).init(params),
             {k: torch.from_numpy(v) for k, v in _batch(256).items()})


def test_trainer_refuses_a_leaf_the_loss_does_not_reach():
    """The launcher's ``Trainer`` shares ``make_train_step``'s gradient
    (``train_loop.value_and_grad``): no zero-fill there either."""
    from repro_torch.training.fault_tolerance import StepFailure
    from repro_torch.training.train_loop import Trainer
    _, cfg = _cfgs("flash")
    params = dict(_port_params(256), stray=torch.ones(3))
    tr = Trainer(functools.partial(tfm.loss_fn, cfg=cfg), opt.adamw(1e-3), params,
                 max_retries=0)
    with pytest.raises(StepFailure) as failed:
        tr.run(iter([_batch(256)]), max_steps=1)
    assert isinstance(failed.value.__cause__, RuntimeError)
    assert tr.step == 0


def test_train_step_mutates_nothing():
    _, cfg = _cfgs("flash")
    params = _port_params(256)
    before = [t.clone() for t in tree_leaves(params)]
    state = opt.adamw(1e-3).init(params)
    step = tfm.make_train_step(cfg, opt.adamw(1e-3))
    new, _, _ = step(params, state, {k: torch.from_numpy(v) for k, v in _batch(256).items()})
    for t, b in zip(tree_leaves(params), before):
        assert torch.equal(t, b) and not t.requires_grad
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(params)))
