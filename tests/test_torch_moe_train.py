"""MoE training in the port against the JAX package: the gradient through
``repro_torch.models.moe.moe_apply`` and the MoE LM's ``loss_fn``,
``make_train_step`` and remat.

On the CPU, in float32, with the JAX weights carried into the port by
``params_from_numpy`` and inputs and cotangents from numpy seeds:

* ``moe_apply``'s VJP for every input (``x``, ``router``, ``w_gate``,
  ``w_up``, ``w_down`` and the ``shared`` tree) against ``jax.vjp`` of
  ``repro.models.moe.moe_apply``, with and without shared experts, at
  capacity factor 1.5 (no pair drops) and 0.5 (pairs drop), the aux loss's
  cotangent included; and, without JAX, its gradient against the dense
  mixture's over the kept pairs (``moe_apply_dense``): a dropped pair,
  which reads slot ``c - 1`` at weight 0, adds nothing to any gradient;
* ``transformer.loss_fn``'s loss, ``ce``, ``moe_aux`` and every gradient
  leaf at both MoE archs' reduced configs (deepseek-moe-16b and
  moonshot-v1-16b-a3b: 8 routed experts top-2, 1 shared, capacity 1.5,
  groups of 64; pairs drop at the test batch), remat on and off in the
  port, on ``"flash"`` (``FlashAttention``'s plain forward and backward on
  the CPU) and ``"chunked"``, against ``jax.value_and_grad`` of the JAX
  ``loss_fn`` (remat off there: ``jax.checkpoint`` changes no value);
* three ``make_train_step`` + ``adamw`` steps of reduced deepseek-moe-16b
  against the JAX package's;
* remat on against off in the port: the same loss and gradients, each
  layer's routing recomputed in the backward equal to its first pass's
  (``(idx, keep)`` as integers), and ``count_drops`` counting each pair
  twice under remat (forward and recompute) with the drop share unchanged.

Tolerances: the loss and its metrics at rtol 1e-5, the gradients and the
trained weights at ``GRAD_TOL`` (``tests/test_torch_lm_train.py``'s).

The ``cuda``-marked tests hold the attention backward at G=1 (deepseek-moe's
H=16, Hkv=16, d=128) against the plain backward, and the float32 MoE
gradient through the kernels against ``"chunked"``; they skip where no card
is present. The JAX side is imported by a fixture, so that they run on a
machine with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_train.py
"""
import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.treepath import tree_map
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import moe, transformer as tfm
from repro_torch.training import optimizer as opt

torch.set_num_threads(2)
#: tests/test_torch_lm_train.py's: float32 sums in another order
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")
B, S = 2, 32     # 64 tokens: one group of 64; S a multiple of attn_chunk (16)


@pytest.fixture(scope="module")
def J():
    """The JAX package's side, and a cache of its jitted results shared by
    the file's tests."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config, reduced as jax_reduced
    from repro.models import moe as jax_moe, transformer as jax_tfm
    from repro.training import optimizer as jax_opt
    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=jax_moe, tfm=jax_tfm, opt=jax_opt,
                                 get_config=jax_get_config, reduced=jax_reduced, cache={})


def _cached(J, key, make):
    if key not in J.cache:
        J.cache[key] = make()
    return J.cache[key]


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _cfgs(J, arch, attn_impl="flash", remat=True, **moe_change):
    """The reduced config in both packages, remat off in JAX (it changes no
    value there), MoE fields changed alike."""
    jcfg = dataclasses.replace(J.reduced(J.get_config(arch)), attn_impl=attn_impl, remat=False)
    cfg = dataclasses.replace(reduced(get_config(arch)), attn_impl=attn_impl, remat=remat)
    if moe_change:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_change))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_change))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(dataclasses.replace(jcfg, remat=remat))
    return jcfg, cfg


def _batch(cfg, seed=3):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _lm(J, arch):
    """JAX's init of the reduced MoE LM (numpy leaves) and the port's copy."""
    def make():
        jp = J.tfm.init_lm(J.jax.random.PRNGKey(0), _cfgs(J, arch)[0])
        return jp, J.jax.tree.map(np.asarray, jp)
    jp, npp = _cached(J, ("lm", arch), make)
    return jp, tfm.params_from_numpy(npp, "cpu")


def _live(tree):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), tree)


def _record_routing(monkeypatch):
    """A list that gets each ``moe_apply`` call's routing, ``(idx, keep)``,
    in call order for the rest of the test (``moe.slots`` wrapped)."""
    seen, slots = [], moe.slots

    def recorded(idx, n_routed, c):
        pos, keep = slots(idx, n_routed, c)
        seen.append((idx.clone(), keep.clone()))
        return pos, keep

    monkeypatch.setattr(moe, "slots", recorded)
    return seen


# --------------------------------------------------------------- moe_apply --

def _moe_layer(J, shared):
    def make():
        jcfg, _ = _cfgs(J, ARCHS[0])
        jp = J.moe.moe_params(J.jax.random.PRNGKey(3), jcfg, J.jnp.float32)
        if not shared:
            jp = {k: v for k, v in jp.items() if k != "shared"}
        return jp
    jp = _cached(J, ("layer", shared), make)
    return jp, tfm.params_from_numpy(J.jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("capacity_factor", [1.5, 0.5])
def test_moe_apply_vjp_matches_jax_for_every_input(J, shared, capacity_factor):
    jcfg, cfg = _cfgs(J, ARCHS[0], capacity_factor=capacity_factor)
    jp, tp = _moe_layer(J, shared)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)      # 2 groups of 64
    dy = rng.standard_normal((2, 64, 64)).astype(np.float32)
    daux = np.float32(0.7)

    def make():
        def fwd_bwd(p, xx, cot):
            out, vjp = J.jax.vjp(lambda pp, xxx: J.moe.moe_apply(pp, xxx, jcfg), p, xx)
            return out, vjp(cot)
        (y, aux), (gp, gx) = J.jax.jit(fwd_bwd)(
            jp, J.jnp.asarray(x), (J.jnp.asarray(dy), J.jnp.asarray(daux)))
        return np.asarray(y), float(aux), J.jax.tree.map(np.asarray, gp), np.asarray(gx)
    jy, jaux, jgp, jgx = _cached(J, ("vjp", shared, capacity_factor), make)

    live, xt = _live(tp), _t(x).requires_grad_(True)
    with moe.count_drops() as n:
        y, aux = moe.moe_apply(live, xt, cfg)
    np.testing.assert_allclose(_np(y), jy, **GRAD_TOL)
    np.testing.assert_allclose(aux.item(), jaux, **GRAD_TOL)
    leaves = _flat(live)
    grads = torch.autograd.grad((y * _t(dy)).sum() + aux * float(daux),
                                [xt, *leaves.values()])
    np.testing.assert_allclose(_np(grads[0]), jgx, err_msg="x", **GRAD_TOL)
    want = _flat(jgp)
    assert set(leaves) == set(want)
    assert ("shared/w_down" in leaves) == shared
    for path, g in zip(leaves, grads[1:]):
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), want[path], err_msg=path, **GRAD_TOL)
    if capacity_factor < 1:
        assert 0 < n.dropped < n.routed
    else:
        assert n.dropped == 0 and n.routed == 256


def test_dropped_pairs_add_no_gradient():
    """At capacity 0.5 one group of 128 tokens drops pairs, and a dropped
    pair gathers slot ``c - 1`` of its expert at weight 0: the gradient of
    ``moe_apply`` for x and every leaf equals the dense mixture's over the
    kept pairs only (``moe_apply_dense`` with ``keep``), which never reads a
    dropped pair's slot."""
    cfg = reduced(get_config(ARCHS[0]))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5,
                                                           group_size=128))
    gen = torch.Generator().manual_seed(4)
    p = moe.moe_params(gen, cfg, torch.float32)
    x = torch.randn((1, 128, cfg.d_model), generator=gen)
    dy = torch.randn((1, 128, cfg.d_model), generator=gen)
    _, idx, _ = moe.route(p["router"], x, cfg.moe)
    _, keep = moe.slots(idx, cfg.moe.n_routed, moe._capacity(cfg.moe, 128))
    assert 0 < int((~keep).sum()) < keep.numel()
    grads = {}
    for name, fn in (("gather", lambda pp, xx: moe.moe_apply(pp, xx, cfg)[0]),
                     ("dense", lambda pp, xx: moe.moe_apply_dense(pp, xx, cfg.moe, keep[0]))):
        live, xt = _live(p), x.clone().requires_grad_(True)
        leaves = _flat(live)
        grads[name] = torch.autograd.grad((fn(live, xt) * dy).sum(), [xt, *leaves.values()])
    for path, g, w in zip(["x", *leaves], grads["gather"], grads["dense"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=path, **GRAD_TOL)


# ---------------------------------------------------------------- loss_fn --

def _jax_value_and_grad(J, arch, attn_impl):
    jcfg, cfg = _cfgs(J, arch, attn_impl)
    jp, _ = _lm(J, arch)

    def make():
        (loss, m), g = J.jax.jit(J.jax.value_and_grad(
            functools.partial(J.tfm.loss_fn, cfg=jcfg), has_aux=True))(
            jp, {k: J.jnp.asarray(v) for k, v in _batch(cfg).items()})
        return (float(loss), {k: float(v) for k, v in m.items()},
                _flat(J.jax.tree.map(np.asarray, g)))
    return _cached(J, ("vg", arch, attn_impl), make)


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("attn_impl", ["flash", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax_grad(J, arch, attn_impl, remat):
    """``loss_fn``'s loss, ce and summed aux, and d loss / d leaf for every
    leaf (each layer's router and shared tree among them, each nonzero),
    against ``jax.value_and_grad`` of the JAX ``loss_fn``; pairs drop at
    this batch; nothing launches on the CPU."""
    _, cfg = _cfgs(J, arch, attn_impl, remat)
    want, want_m, want_g = _jax_value_and_grad(J, arch, attn_impl)
    _, tp = _lm(J, arch)
    live = _live(tp)
    before = (FA.launches, FA.bwd_launches)
    with moe.count_drops() as n:
        loss, metrics = tfm.loss_fn(live, {k: _t(v) for k, v in _batch(cfg).items()}, cfg)
        leaves = _flat(live)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert (FA.launches, FA.bwd_launches) == before
    assert n.dropped > 0
    np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    for key in ("ce", "moe_aux"):
        np.testing.assert_allclose(metrics[key].item(), want_m[key], rtol=1e-5, err_msg=key)
    assert set(grads) == set(want_g)
    assert {"layers/moe/router", "layers/moe/shared/w_up", "lm_head"} <= set(grads)
    for path, g in grads.items():
        assert bool(g.abs().max() > 0), f"{path}: zero gradient"
        np.testing.assert_allclose(_np(g), want_g[path], err_msg=path, **GRAD_TOL)


def test_three_train_steps_match_jax(J):
    """Three ``make_train_step`` steps with ``adamw`` (the launcher's
    warmup-cosine schedule) on reduced deepseek-moe-16b against the JAX
    package's: each step's loss, ce and moe_aux at rtol 1e-5 and every leaf
    after the third at GRAD_TOL."""
    arch = ARCHS[0]
    jcfg, cfg = _cfgs(J, arch)
    batches = [_batch(cfg, seed=10 + i) for i in range(3)]

    def make():
        jstep = J.jax.jit(J.tfm.make_train_step(jcfg, J.opt.adamw(
            J.opt.warmup_cosine_schedule(1e-3, 10, 30))))
        jp, _ = _lm(J, arch)
        js = J.opt.adamw(1e-3).init(jp)
        metrics = []
        for batch in batches:
            jp, js, jm = jstep(jp, js, {k: J.jnp.asarray(v) for k, v in batch.items()})
            metrics.append({k: float(v) for k, v in jm.items()})
        return metrics, _flat(J.jax.tree.map(np.asarray, jp))
    jmetrics, want = _cached(J, ("steps", arch), make)

    step = tfm.make_train_step(cfg, opt.adamw(opt.warmup_cosine_schedule(1e-3, 10, 30)))
    _, p = _lm(J, arch)
    st = opt.adamw(1e-3).init(p)
    for i, batch in enumerate(batches):
        p, st, m = step(p, st, {k: _t(v) for k, v in batch.items()})
        for key in ("loss", "ce", "moe_aux"):
            np.testing.assert_allclose(m[key].item(), jmetrics[i][key], rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    for path, leaf in _flat(p).items():
        np.testing.assert_allclose(_np(leaf), want[path], err_msg=path, **GRAD_TOL)
    assert int(st["step"]) == 3


# ------------------------------------------------------------------ remat --

@pytest.mark.parametrize("attn_impl", ["flash", "chunked"])
def test_remat_recomputes_the_same_routing_and_gradients(attn_impl, monkeypatch):
    """Under remat each layer's ``moe_apply`` runs twice a step: in the
    forward (layers 0..L-1) and again in the backward (L-1..0). The
    recomputed routing equals the first pass's as integers (idx and keep),
    and the loss, every gradient leaf and the drop share equal remat off's;
    ``count_drops`` counts each pair twice under remat."""
    routings = _record_routing(monkeypatch)
    cfg0 = dataclasses.replace(reduced(get_config(ARCHS[0])), attn_impl=attn_impl)
    params = tfm.init_lm(cfg0, torch.Generator().manual_seed(0), "cpu")
    batch = {k: _t(v) for k, v in _batch(cfg0).items()}
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(cfg0, remat=remat)
        routings.clear()
        live = _live(params)
        with moe.count_drops() as n:
            loss, m = tfm.loss_fn(live, batch, cfg)
            leaves = _flat(live)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        out[remat] = (loss, m["moe_aux"], grads, n.routed, n.dropped, list(routings))
    n_layers = cfg0.n_layers
    on, off = out[True], out[False]
    assert len(on[5]) == 2 * n_layers and len(off[5]) == n_layers
    for i in range(n_layers):     # the recompute runs the layers in reverse
        for first, again in ((on[5][i], on[5][2 * n_layers - 1 - i]), (on[5][i], off[5][i])):
            assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    assert torch.equal(on[0], off[0]) and torch.equal(on[1], off[1])
    for g_on, g_off in zip(on[2], off[2]):
        assert torch.equal(g_on, g_off)
    assert on[3] == 2 * off[3] and on[4] == 2 * off[4] and off[4] > 0
    assert on[4] / on[3] == off[4] / off[3]


# -------------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the attention kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [1, 63, 130, 257])
def test_cuda_g1_backward_matches_plain(cuda_device, dtype, s):
    """deepseek-moe-16b's attention (H=16, Hkv=16, d=128: G=1) both ways on
    the card: one forward and one backward launch a call, the gradients
    against the plain backward's (bfloat16 at 2e-2, float32 3xTF32 at
    1e-4)."""
    cfg = get_config(ARCHS[0])
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    assert h == hkv
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda_device).manual_seed(s)
    q, k, v, dout = (torch.randn((2, s, n, d), generator=gen, device=cuda_device).to(dt)
                     for n in (h, hkv, hkv, h))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    before = (FA.launches, FA.bwd_launches)
    out = FA.flash_attention(q, k, v)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (FA.launches, FA.bwd_launches) == (before[0] + 1, before[1] + 1)
    qd, kd, vd = (t.detach() for t in (q, k, v))
    want_out, lse = FA.flash_attention_fwd_plain(qd, kd, vd)
    want = FA.flash_attention_bwd_plain(qd, kd, vd, want_out, lse, dout)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=1e-4, atol=1e-4)
    for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g.float(), w.float(), **tol, msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
def test_cuda_float32_moe_gradient_through_the_kernels_matches_chunked(cuda_device,
                                                                     monkeypatch):
    """A float32 MoE LM at deepseek-moe-16b's head layout (H=Hkv, d=128) on
    the card: the loss and every gradient leaf through the float32 kernels
    ("flash", remat: 2 forward and 1 backward launches a layer) against
    plain autograd ("chunked") from the same weights, after each layer's
    routing (idx, keep) is asserted equal; each leaf's error norm within
    1e-4 of its gradient's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced(get_config(ARCHS[0])), d_model=256, n_heads=2,
                              n_kv_heads=2, d_head=128)
    params = tfm.init_lm(cfg, torch.Generator(cuda_device).manual_seed(0), cuda_device)
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda_device,
                         generator=torch.Generator(cuda_device).manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    routings = _record_routing(monkeypatch)
    results = {}
    for impl in ("flash", "chunked"):
        routings.clear()
        live = _live(params)
        before = (FA.launches, FA.bwd_launches)
        loss, _ = tfm.loss_fn(live, batch, dataclasses.replace(cfg, attn_impl=impl))
        leaves = _flat(live)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        results[impl] = (loss.item(), grads, list(routings),
                         (FA.launches - before[0], FA.bwd_launches - before[1]))
    assert results["flash"][3] == (2 * cfg.n_layers, cfg.n_layers)
    assert results["chunked"][3] == (0, 0)
    assert len(results["flash"][2]) == len(results["chunked"][2]) == 2 * cfg.n_layers
    for (idx, keep), (want_idx, want_keep) in zip(results["flash"][2], results["chunked"][2]):
        assert torch.equal(idx, want_idx) and torch.equal(keep, want_keep)
    np.testing.assert_allclose(results["flash"][0], results["chunked"][0], rtol=1e-5)
    for path, g, w in zip(leaves, results["flash"][1], results["chunked"][1]):
        rel = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)).item()
        assert rel <= 1e-4, (path, rel)
