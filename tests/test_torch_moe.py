"""The port's MoE layer (``repro_torch.models.moe``) and the MoE LM built on
it against the JAX package's ``repro.models.moe`` and
``repro.models.transformer``.

On ``reduced(deepseek-moe-16b)`` (2 layers, d_model 64, 8 routed experts of
width 32, top-2, 1 shared, float32) on the CPU, with the JAX weights carried
into the port by ``params_from_numpy`` (and through ``RPROAVRO1``) and inputs
from numpy seeds:

* the routing as integers: ``route``'s expert indices, ties among them
  (a router with duplicated columns, where the lower index must win), and
  each (token, choice) pair's slot and whether it is kept, against a copy
  of the JAX function's cumsums and against a first-come-first-served loop,
  at an ample capacity and at one where a group overflows;
* ``route``'s weights, ``moe_apply``'s output and the aux loss at the
  repo's score tolerance (rtol 1e-4, atol 1e-5), with and without shared
  experts, at capacity factors 8.0 and 0.5, and group sizes 32 and 128;
* ``forward`` (logits and the summed aux), ``prefill`` (logits and cache)
  and ``decode_step`` of the reduced MoE model at ``tests/test_torch_lm.py``'s
  tolerances, decode after prefill against forward at
  ``tests/test_arch_smoke.py``'s, and the MoE tree through ``RPROAVRO1`` in
  both directions.

``moe_apply_dense`` (every expert on every token) is the reference where a
test says "the dense mixture". The ``cuda``-marked test holds ``moe_apply``
on the card against it and skips where no card is present. The JAX side is imported by a
fixture, so that it runs on a machine with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import export
from repro_torch.models import layers as L, moe, transformer as tfm

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
ARCH = "deepseek-moe-16b"


@pytest.fixture(scope="module")
def J():
    """The JAX package's side of the comparison, and a cache of its
    weights and outputs shared by the file's tests."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config, reduced as jax_reduced
    from repro.core import export as jax_export
    from repro.models import moe as jax_moe, transformer as jax_tfm
    return types.SimpleNamespace(jax=jax, jnp=jnp, moe=jax_moe, tfm=jax_tfm,
                                 export=jax_export, get_config=jax_get_config,
                                 cfg=jax_reduced(jax_get_config(ARCH)), cache={})


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(J, **moe_change):
    """The reduced config in both packages (remat off in JAX: the port does
    not rematerialise, and it changes no value), MoE fields changed alike."""
    jcfg = dataclasses.replace(J.cfg, remat=False)
    cfg = reduced(get_config(ARCH))
    if moe_change:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_change))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_change))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(dataclasses.replace(jcfg, remat=True))
    return jcfg, cfg


def _cached(J, key, make):
    if key not in J.cache:
        J.cache[key] = make()
    return J.cache[key]


def _lm(J):
    """The JAX init of the reduced MoE LM and the port's copy."""
    def make():
        jp = J.tfm.init_lm(J.jax.random.PRNGKey(0), _cfgs(J)[0])
        return jp, tfm.params_from_numpy(J.jax.tree.map(np.asarray, jp), "cpu")
    return _cached(J, "lm", make)


def _layer(J, shared=True):
    """One MoE layer's weights (JAX's ``moe_params``) in both packages."""
    def make():
        jp = J.moe.moe_params(J.jax.random.PRNGKey(3), _cfgs(J)[0], J.jnp.float32)
        if not shared:
            jp = {k: v for k, v in jp.items() if k != "shared"}
        return jp, tfm.params_from_numpy(J.jax.tree.map(np.asarray, jp), "cpu")
    return _cached(J, ("layer", shared), make)


def _x(b=2, s=64, d=64, seed=2):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _tokens(b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _jax_slots(J, idx, e, c):
    """``pos`` and ``keep`` as the JAX package's ``moe_apply`` computes them
    (``src/repro/models/moe.py:84-93``), from its expert indices."""
    jnp = J.jnp
    counts = jnp.zeros((idx.shape[0], e), jnp.int32)
    pos = []
    for j in range(idx.shape[-1]):
        oh = J.jax.nn.one_hot(idx[:, :, j], e, dtype=jnp.int32)
        excl = jnp.cumsum(oh, axis=1) - oh
        pos.append(jnp.take_along_axis(excl + counts[:, None, :],
                                       idx[:, :, j:j + 1], axis=2)[..., 0])
        counts = counts + jnp.sum(oh, axis=1)
    pos = jnp.stack(pos, axis=-1)
    return np.asarray(pos), np.asarray(pos < c)


def _fcfs_slots(idx, e):
    """The same slots from their definition: choices in order j = 0..k-1,
    tokens in order, each taking its expert's next free slot."""
    g, s, k = idx.shape
    pos = np.zeros_like(idx)
    for gi in range(g):
        taken = np.zeros(e, np.int64)
        for j in range(k):
            for si in range(s):
                pos[gi, si, j] = taken[idx[gi, si, j]]
                taken[idx[gi, si, j]] += 1
    return pos


# ------------------------------------------------------------------ config --

@pytest.mark.parametrize("small", [False, True])
def test_config_matches_jax(J, small):
    jcfg, cfg = J.get_config(ARCH), get_config(ARCH)
    if small:
        jcfg, cfg = J.cfg, reduced(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    if not small:
        assert (cfg.n_params(), cfg.n_active_params()) == (16_879_452_160, 2_830_630_912)
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.d_head) == (16, 16, 128)   # G = 1


@pytest.mark.parametrize("s", [1, 2, 8, 24, 64, 260, 2048, 32768])
def test_capacity_matches_jax(J, s):
    for spec in (J.get_config(ARCH).moe, J.cfg.moe):
        ours = dataclasses.replace(get_config(ARCH).moe, **dataclasses.asdict(spec))
        assert moe._capacity(ours, s) == J.moe._capacity(spec, s)
    assert moe._capacity(get_config(ARCH).moe, 2048) == 240


# ----------------------------------------------------------------- routing --

def test_route_matches_jax(J):
    jcfg, cfg = _cfgs(J)
    jp, tp = _layer(J)
    x = _x().reshape(4, 32, 64)
    jw, jidx, jaux = J.moe.route(jp["router"], J.jnp.asarray(x), jcfg.moe)
    w, idx, aux = moe.route(tp["router"], _t(x), cfg.moe)
    assert idx.dtype == torch.int64 and tuple(idx.shape) == (4, 32, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


def test_route_ties_go_to_the_lower_index(J):
    """A router whose columns repeat gives equal logits for the repeated
    experts: the lower index is chosen first in both packages. Inputs and
    router entries are small multiples of powers of two, so every product
    and sum is exact and the logits tie bit for bit."""
    jcfg, cfg = _cfgs(J, top_k=3)
    rng = np.random.default_rng(7)
    base = rng.integers(-4, 5, (64, 4)).astype(np.float32) / 8
    router = base[:, [0, 1, 0, 2, 1, 3, 3, 0]]     # experts 0=2=7, 1=4, 5=6
    x = rng.integers(-2, 3, (2, 16, 64)).astype(np.float32)
    jw, jidx, jaux = J.moe.route(J.jnp.asarray(router), J.jnp.asarray(x), jcfg.moe)
    w, idx, aux = moe.route(_t(router), _t(x), cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    probs = torch.softmax(_t(x) @ _t(router), dim=-1)
    picked = torch.gather(probs, -1, idx)
    tied = 0
    for j in range(2):   # an equal next pick lies at a higher index
        same = picked[..., j] == picked[..., j + 1]
        tied += int(same.sum())
        assert bool((idx[..., j][same] < idx[..., j + 1][same]).all())
    assert tied > 0


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_slots_match_jax(J, capacity_factor):
    jcfg, cfg = _cfgs(J, capacity_factor=capacity_factor)
    jp, tp = _layer(J)
    x = _x(s=64).reshape(1, 128, 64)     # one group of 128 tokens
    c = moe._capacity(cfg.moe, 128)
    _, jidx, _ = J.moe.route(jp["router"], J.jnp.asarray(x), jcfg.moe)
    _, idx, _ = moe.route(tp["router"], _t(x), cfg.moe)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    pos, keep = moe.slots(idx, cfg.moe.n_routed, c)
    jpos, jkeep = _jax_slots(J, jidx, cfg.moe.n_routed, c)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(keep.numpy(), jkeep)
    np.testing.assert_array_equal(pos.numpy(), _fcfs_slots(idx.numpy(), cfg.moe.n_routed))
    if capacity_factor < 1:   # the group overflows: some pairs drop
        assert 0 < int((~keep).sum()) < keep.numel()
        # a token's second choice queues behind every token's first choice
        assert int(keep[..., 1].sum()) < int(keep[..., 0].sum())
    else:
        assert bool(keep.all())


# --------------------------------------------------------------- moe_apply --

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_apply_matches_jax(J, shared, capacity_factor):
    jcfg, cfg = _cfgs(J, capacity_factor=capacity_factor)
    jp, tp = _layer(J, shared)
    x = _x()
    jy, jaux = J.moe.moe_apply(jp, J.jnp.asarray(x), jcfg)
    with moe.count_drops() as n:
        y, aux = moe.moe_apply(tp, _t(x), cfg)
    assert tuple(y.shape) == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # 2 x 64 tokens in groups of 64, k = 2: the pairs counted, the drops
    # those of slots() over each group
    _, idx, _ = moe.route(tp["router"], _t(x).reshape(2, 64, 64), cfg.moe)
    _, keep = moe.slots(idx, cfg.moe.n_routed, moe._capacity(cfg.moe, 64))
    assert n.routed == 256 and n.dropped == int((~keep).sum())
    if capacity_factor < 1:
        assert n.dropped > 0 and 0 < n.share < 1
    else:
        assert n.dropped == 0
        np.testing.assert_allclose(y.numpy(), moe.moe_apply_dense(tp, _t(x), cfg.moe).numpy(), **TOL)


def test_dropped_pairs_add_nothing(J):
    """At capacity 0.5 each token's output is the dense mixture over its
    kept pairs only: a dropped pair adds exactly nothing."""
    _, cfg = _cfgs(J, capacity_factor=0.5)
    _, tp = _layer(J, shared=False)
    x = _t(_x()).reshape(1, 128, 64)
    cfg1 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, group_size=128))
    y, _ = moe.moe_apply(tp, x, cfg1)
    _, idx, _ = moe.route(tp["router"], x, cfg.moe)
    _, keep = moe.slots(idx, cfg.moe.n_routed, moe._capacity(cfg.moe, 128))
    want = moe.moe_apply_dense(tp, x, cfg.moe, keep[0])
    np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL)
    none_kept = ~keep[0].any(-1)
    assert int(none_kept.sum()) > 0 and bool((y[0][none_kept] == 0).all())


def test_group_invariance(J):
    """With ample capacity the group size changes no value (the JAX suite's
    ``test_moe_group_invariance``), in both packages."""
    outs = []
    for group_size in (32, 128):
        jcfg, cfg = _cfgs(J, capacity_factor=8.0, group_size=group_size)
        jp, tp = _layer(J)
        jy, _ = J.moe.moe_apply(jp, J.jnp.asarray(_x()), jcfg)
        y, _ = moe.moe_apply(tp, _t(_x()), cfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        outs.append(y.numpy())
    np.testing.assert_allclose(outs[0], outs[1], **TOL)


def test_moe_params_tree_and_dtypes():
    """The router stays float32 in a bfloat16 model; the experts take the
    model's type; the draws have the JAX init's scales."""
    cfg = reduced(get_config(ARCH))
    p = moe.moe_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert sorted(p) == ["router", "shared", "w_down", "w_gate", "w_up"]
    assert p["router"].dtype == torch.float32 and tuple(p["router"].shape) == (64, 8)
    assert p["w_gate"].dtype == torch.bfloat16 and tuple(p["w_gate"].shape) == (8, 64, 32)
    assert tuple(p["w_down"].shape) == (8, 32, 64)
    assert tuple(p["shared"]["w_gate"].shape) == (64, 32)
    assert abs(float(p["router"].std()) - 64 ** -0.5) < 0.02
    assert abs(float(p["w_down"].float().std()) - 32 ** -0.5) < 0.02


# ---------------------------------------------------------------------- LM --

def test_forward_prefill_decode_match_jax(J):
    jcfg, cfg = _cfgs(J)
    jp, tp = _lm(J)
    toks = _tokens()
    want, jaux = J.tfm.forward(jp, J.jnp.asarray(toks), jcfg)
    got, aux = tfm.forward(tp, _t(toks), cfg)
    assert tuple(got.shape) == (2, 12, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    assert float(aux) > 0          # the sum of two layers' losses

    jl, jc = J.tfm.prefill(jp, J.jnp.asarray(toks), jcfg)
    tl, tc = tfm.prefill(tp, _t(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]), **TOL)

    jcache = J.tfm.init_cache(jcfg, 2, 16)
    jcache = {k: v.at[:, :, :12].set(jc[k]) for k, v in jcache.items()}
    tcache = tfm.init_cache(cfg, 2, 16, device="cpu")
    for key in ("k", "v"):
        tcache[key][:, :, :12] = tc[key]
    new, pos = np.array([3, 7], np.int32), np.array([12, 9], np.int32)
    jl, jcache = J.tfm.decode_step(jp, jcache, J.jnp.asarray(new), J.jnp.asarray(pos), jcfg)
    tl, tcache = tfm.decode_step(tp, tcache, _t(new), _t(pos), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]), **TOL)


def test_loss_fn_adds_the_aux_loss_as_jax(J):
    jcfg, cfg = _cfgs(J)
    jp, tp = _lm(J)
    toks = _tokens(seed=5)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jloss, jm = J.tfm.loss_fn(jp, {k: J.jnp.asarray(v) for k, v in batch.items()}, jcfg)
    loss, m = tfm.loss_fn(tp, {k: _t(v) for k, v in batch.items()}, cfg)
    for a, b in ((loss, jloss), (m["ce"], jm["ce"]), (m["moe_aux"], jm["moe_aux"])):
        np.testing.assert_allclose(float(a), float(b), **TOL)
    np.testing.assert_allclose(float(loss), float(m["ce"]) + 0.01 * float(m["moe_aux"]),
                               rtol=1e-6)


def test_decode_after_prefill_reproduces_forward():
    """``tests/test_arch_smoke.py::test_lm_prefill_decode_consistency`` for
    the port's MoE model: capacity 16, where no slot drops, so a 1-token
    decode routes as the full pass does; its tolerance."""
    cfg = reduced(get_config(ARCH))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    tp = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(s=16, seed=4))
    full, _ = tfm.forward(tp, toks, cfg)
    lg_prefill, cache = tfm.prefill(tp, toks[:, :-1], cfg)
    cache_full = tfm.init_cache(cfg, 2, 24, device="cpu")
    for key in ("k", "v"):
        cache_full[key][:, :, :15] = cache[key]
    lg_decode, _ = tfm.decode_step(tp, cache_full, toks[:, -1],
                                   torch.full((2,), 15, dtype=torch.int32), cfg)
    np.testing.assert_allclose(lg_decode.numpy(), full[:, -1].numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lg_prefill.numpy(), full[:, -2].numpy(), rtol=2e-2, atol=2e-2)


def test_init_lm_has_the_jax_tree(J):
    jcfg, cfg = _cfgs(J)
    jtree = J.jax.tree.map(np.asarray, J.tfm.init_lm(J.jax.random.PRNGKey(0), jcfg))
    tree = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    jflat, flat = J.export._flatten_named(jtree), export.flatten_named(tree)
    assert sorted(flat) == sorted(jflat)
    assert "layers/moe/router" in flat and "layers/moe/shared/w_down" in flat
    for name, arr in flat.items():
        assert arr.shape == jflat[name].shape and arr.dtype == jflat[name].dtype, name
    assert flat["layers/moe/w_gate"].shape == (cfg.n_layers, 8, 64, 32)
    # in a bfloat16 model the router stays float32 in both packages
    jm = J.tfm.init_lm(J.jax.random.PRNGKey(0), dataclasses.replace(jcfg, dtype="bfloat16"))
    m = tfm.init_lm(dataclasses.replace(cfg, dtype="bfloat16"),
                    torch.Generator().manual_seed(0), "cpu")
    for key, dt in (("router", "float32"), ("w_gate", "bfloat16"), ("w_down", "bfloat16")):
        assert str(jm["layers"]["moe"][key].dtype) == dt
        assert m["layers"]["moe"][key].dtype == getattr(torch, dt)
    assert m["layers"]["moe"]["shared"]["w_up"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen3-0.6b", ARCH])
def test_init_lm_fills_each_layer_in_draw_order(arch):
    """``init_lm`` fills its stacked leaves layer by layer: the tree equals
    the embedding, then ``init_layer`` once a layer, then the head, drawn
    in that order from one generator and stacked."""
    cfg = reduced(get_config(arch))
    got = export.flatten_named(tfm.init_lm(cfg, torch.Generator().manual_seed(5), "cpu"))
    gen = torch.Generator().manual_seed(5)
    embed = L.embed_init(gen, cfg.vocab_padded, cfg.d_model, torch.float32)
    per_layer = [export.flatten_named(tfm.init_layer(gen, cfg)) for _ in range(cfg.n_layers)]
    np.testing.assert_array_equal(got["embed"], embed.numpy())
    if not cfg.tie_embeddings:
        head = L.dense_init(gen, cfg.d_model, cfg.vocab_padded, torch.float32)
        np.testing.assert_array_equal(got["lm_head"], head.numpy())
    for name in per_layer[0]:
        np.testing.assert_array_equal(got[f"layers/{name}"],
                                      np.stack([t[name] for t in per_layer]), err_msg=name)


def test_moe_tree_round_trips_through_export(J):
    jcfg, cfg = _cfgs(J)
    jp, tp = _lm(J)
    toks = _tokens()
    want, _ = J.tfm.forward(jp, J.jnp.asarray(toks), jcfg)
    # JAX writes, the port reads
    flat, header = export.loads(J.export.dumps(jp, model="deepseek-moe-16b-smoke"))
    assert header["model"] == "deepseek-moe-16b-smoke" and "layers/moe/router" in flat
    got, _ = tfm.forward(tfm.params_from_numpy(export.unflatten(flat), "cpu"), _t(toks), cfg)
    np.testing.assert_array_equal(got.numpy(), tfm.forward(tp, _t(toks), cfg)[0].numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port writes, the JAX package reads, tensor for tensor
    jflat, _ = J.export.loads(export.dumps(tp))
    for name, arr in export.flatten_named(tp).items():
        np.testing.assert_array_equal(jflat[name], arr)
    jgot, _ = J.tfm.forward(J.export.restore_into(jp, jflat), J.jnp.asarray(toks), jcfg)
    np.testing.assert_array_equal(np.asarray(jgot), np.asarray(want))


# -------------------------------------------------------------------- card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cuda_moe_apply_matches_the_dense_mixture(cuda_device, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_config(ARCH))
    cfg = dataclasses.replace(cfg, dtype=dtype,
                              moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    dt = getattr(torch, dtype)
    gen = torch.Generator(cuda_device).manual_seed(0)
    p = moe.moe_params(gen, cfg, dt)
    x = torch.randn((2, 64, cfg.d_model), generator=gen, device=cuda_device).to(dt)
    y, aux = moe.moe_apply(p, x, cfg)
    want = moe.moe_apply_dense(p, x, cfg.moe)
    tol = TOL if dtype == "float32" else dict(rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(y, want, **tol)
    assert y.device.type == "cuda" and torch.isfinite(aux)
