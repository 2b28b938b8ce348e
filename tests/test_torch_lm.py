"""The port's LM serving path against ``repro.models.transformer`` and
``repro.models.layers`` on the same inputs and weights.

Inputs are made with numpy from a seed; JAX parameters come from
``repro.models.transformer.init_lm`` and reach the port through
``params_from_numpy``. Everything runs in float32 on the CPU, where the
point is the algorithm; the tolerance is the repo's score tolerance
(``rtol=1e-4, atol=1e-5``) unless a test states another and why. With
``attn_impl="flash"`` the port's attention is the kernel wrapper, which on
CPU tensors runs its plain version (``tests/test_torch_flash.py`` holds
that against the Pallas kernel).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import LM_SHAPES as JAX_LM_SHAPES
from repro.configs import get_config as jax_get_config, reduced as jax_reduced
from repro.core import export as jax_export
from repro.data import lm as jax_lm
from repro.models import layers as jax_layers, transformer as jax_tfm
from repro_torch.configs import LM_SHAPES, get_config, reduced
from repro_torch.core import export
from repro_torch.data import lm
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers, transformer as tfm

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)


def _np(x):
    """A JAX array or a tensor as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(vocab=None):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen3-0.6b")), remat=False)
    cfg = reduced(get_config("qwen3-0.6b"))
    if vocab is not None:   # 250 pads to 256: the padded-vocab mask runs
        jcfg = dataclasses.replace(jcfg, vocab_size=vocab)
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(jcfg):
    """JAX parameters (jnp) and the port's (via params_from_numpy), cached
    per config so the file's tests share one init."""
    jp = jax_tfm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jp, tfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ------------------------------------------------------------------ config --

@pytest.mark.parametrize("small", [False, True])
def test_config_matches_jax(small):
    jcfg, cfg = jax_get_config("qwen3-0.6b"), get_config("qwen3-0.6b")
    if small:
        jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert cfg.n_params() == jcfg.n_params()
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert [dataclasses.asdict(s) for s in LM_SHAPES] == \
        [dataclasses.asdict(s) for s in JAX_LM_SHAPES]
    if not small:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
                cfg.d_ff, cfg.vocab_size, cfg.vocab_padded) == \
            (28, 1024, 16, 8, 128, 3072, 151936, 151936)
        # every kernel, both directions and types, is compiled at this width
        assert all(cfg.d_head in dims for dims in FA.KERNEL_HEAD_DIMS.values())


def test_token_batches_match_jax():
    ours = lm.token_batches(1000, 3, 17, seed=5)
    theirs = jax_lm.token_batches(1000, 3, 17, seed=5)
    for _ in range(2):
        a, b = next(ours), next(theirs)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------------------------ layers --

def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 3).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jax_layers.rms_norm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(layers.rms_norm(_t(x), _t(w)).numpy(), _np(want), **TOL)
    # bfloat16 in, bfloat16 out, normalised in float32 in both
    got = layers.rms_norm(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16))
    want = jax_layers.rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(w).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 ** -7, atol=0)


def test_rope_matches_jax():
    theta, d = 1e6, 128
    pos = np.arange(4097)
    jc, js = jax_layers.rope_table(jnp.asarray(pos), d, theta)
    tc, ts = layers.rope_table(_t(pos), d, theta)
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (4097, d // 2)
    # XLA's exp and torch's exp round a few of the 64 float32 frequencies one
    # ulp apart; the angle pos * freq carries that ulp times the position, so
    # the tables agree to pos_max * 2**-23 (4.9e-4 at 4096), and to the
    # repo's tolerance up to position 64
    tol = 4096 * 2.0 ** -23
    for a, b in ((tc, jc), (ts, js)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)
        np.testing.assert_allclose(a.numpy()[:65], np.asarray(b)[:65], **TOL)
    # the rotation on the same tables: half-split, as in JAX
    x = np.random.default_rng(2).standard_normal((2, 4097, 3, d)).astype(np.float32)
    got = layers.apply_rope(_t(x), _t(jc), _t(js))
    want = jax_layers.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-6, atol=1e-6)
    e0 = torch.zeros((1, 1, d))
    e0[..., 0] = 1.0       # the first lane pairs with lane d/2, not lane 1
    out = layers.apply_rope(e0[None], tc[None, 7:8], ts[None, 7:8])[0, 0, 0]
    assert out[0] == tc[7, 0] and out[d // 2] == ts[7, 0] and out[1] == 0


@pytest.mark.parametrize("qk_norm", [True, False])
def test_qkv_project_matches_jax(qk_norm):
    rng = np.random.default_rng(3)
    d_model, h, hkv, dh = 64, 4, 2, 16
    p = {"wq": rng.standard_normal((d_model, h * dh)) / 8,
         "wk": rng.standard_normal((d_model, hkv * dh)) / 8,
         "wv": rng.standard_normal((d_model, hkv * dh)) / 8}
    if qk_norm:   # not ones, so that a norm applied in the wrong place shows
        p["q_norm"] = 1 + 0.5 * rng.standard_normal(dh)
        p["k_norm"] = 1 + 0.5 * rng.standard_normal(dh)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 9, d_model)).astype(np.float32)
    pos = np.arange(100, 109)
    want = jax_layers.qkv_project({k: jnp.asarray(v) for k, v in p.items()},
                                  jnp.asarray(x), h, hkv, dh, jnp.asarray(pos), 1e6)
    got = layers.qkv_project({k: _t(v) for k, v in p.items()}, _t(x), h, hkv, dh,
                             _t(pos), 1e6)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


def test_swiglu_matches_jax():
    rng = np.random.default_rng(4)
    p = {k: (rng.standard_normal(s) / 8).astype(np.float32)
         for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = jax_layers.swiglu_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = layers.swiglu_apply({k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_repeat_kv_maps_head_h_to_kv_head_h_over_g():
    k = torch.arange(2 * 3 * 2 * 4, dtype=torch.float32).reshape(2, 3, 2, 4)
    rep = layers.repeat_kv(k, 3)
    want = jax_layers.repeat_kv(jnp.asarray(k.numpy()), 3)
    np.testing.assert_array_equal(rep.numpy(), np.asarray(want))
    for h in range(6):
        assert torch.equal(rep[:, :, h], k[:, :, h // 3])


@pytest.mark.parametrize("s", [12, 48])   # S <= chunk (one pass), S > chunk
def test_causal_attention_matches_jax(s):
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, s, h, 16)).astype(np.float32) for h in (4, 2, 2))
    want = jax_layers.causal_attention(*(jnp.asarray(a) for a in (q, k, v)), chunk=16)
    got = layers.causal_attention(_t(q), _t(k), _t(v), chunk=16)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # and the kernel wrapper (plain version on the CPU) computes the same
    np.testing.assert_allclose(FA.flash_attention(_t(q), _t(k), _t(v)).numpy(),
                               got.numpy(), **TOL)


@pytest.mark.parametrize("with_len", [True, False])
def test_decode_attention_matches_jax(with_len):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 12, 2, 16)).astype(np.float32) for _ in range(2))
    kv_len = np.array([1, 5, 12], np.int32) if with_len else None
    want = jax_layers.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                       None if kv_len is None else jnp.asarray(kv_len))
    got = layers.decode_attention(_t(q), _t(kc), _t(vc),
                                  None if kv_len is None else _t(kv_len))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    if with_len:   # row 0 sees position 0 only: its output is v[0] of its KV head
        np.testing.assert_allclose(got[0, 0].numpy(),
                                   np.repeat(vc[0, 0], 2, axis=0), **TOL)


# ------------------------------------------------------------------- slice --

@pytest.mark.parametrize("vocab", [None, 250])
def test_forward_prefill_decode_match_jax(vocab):
    jcfg, cfg = _cfgs(vocab)
    jp, tp = _weights(jcfg)
    toks = _tokens(cfg)
    want, _ = jax_tfm.forward(jp, jnp.asarray(toks), jcfg)
    got, aux = tfm.forward(tp, _t(toks), cfg)
    assert tuple(got.shape) == (2, 12, cfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    if vocab is not None:   # padded columns are masked in both
        assert (got[..., cfg.vocab_size:] == -1e30).all()

    jl, jc = jax_tfm.prefill(jp, jnp.asarray(toks), jcfg)
    tl, tc = tfm.prefill(tp, _t(toks), cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), _np(jc[key]), **TOL)

    # one decode step at position 12 (row 0) and 9 (row 1) on a 16-slot cache
    jcache = jax_tfm.init_cache(jcfg, 2, 16)
    jcache = {k: v.at[:, :, :12].set(jc[k]) for k, v in jcache.items()}
    tcache = tfm.init_cache(cfg, 2, 16, device="cpu")
    for key in ("k", "v"):
        tcache[key][:, :, :12] = tc[key]
    new = np.array([3, 7], np.int32)
    pos = np.array([12, 9], np.int32)
    jl, jcache = jax_tfm.decode_step(jp, jcache, jnp.asarray(new), jnp.asarray(pos), jcfg)
    tl, tcache = tfm.decode_step(tp, tcache, _t(new), _t(pos), cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), _np(jcache[key]), **TOL)


@pytest.mark.parametrize("s", [12, 32])   # one chunk, two chunks of 16
def test_flash_matches_chunked(s):
    jcfg, cfg = _cfgs()
    _, tp = _weights(jcfg)
    toks = _t(_tokens(cfg, s=s, seed=2))
    chunked = dataclasses.replace(cfg, attn_impl="chunked")
    before = FA.launches
    np.testing.assert_allclose(tfm.forward(tp, toks, cfg)[0].numpy(),
                               tfm.forward(tp, toks, chunked)[0].numpy(), **TOL)
    fl, fc = tfm.prefill(tp, toks, cfg)
    cl, cc = tfm.prefill(tp, toks, chunked)
    assert FA.launches == before   # CPU tensors: the plain version, no launch
    np.testing.assert_allclose(fl.numpy(), cl.numpy(), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(fc[key].numpy(), cc[key].numpy(), **TOL)


def test_sixteen_decode_steps_from_an_empty_cache_match_forward():
    jcfg, cfg = _cfgs(250)
    jp, tp = _weights(jcfg)
    toks = _tokens(cfg, s=16, seed=3)
    full, _ = tfm.forward(tp, _t(toks), cfg)
    cache = tfm.init_cache(cfg, 2, 24, device="cpu")
    for t in range(16):
        lg, cache = tfm.decode_step(tp, cache, _t(toks[:, t]),
                                    torch.full((2,), t, dtype=torch.int32), cfg)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), **TOL)
    # the JAX package's 16 steps end on the same logits
    jcache = jax_tfm.init_cache(jcfg, 2, 24)
    for t in range(16):
        jl, jcache = jax_tfm.decode_step(jp, jcache, jnp.asarray(toks[:, t]),
                                         jnp.full((2,), t, jnp.int32), jcfg)
    np.testing.assert_allclose(lg.numpy(), _np(jl), **TOL)


def test_decode_after_prefill_reproduces_forward():
    """The port's mirror of ``test_lm_prefill_decode_consistency``, at that
    test's tolerance."""
    jcfg, cfg = _cfgs()
    _, tp = _weights(jcfg)
    toks = _t(_tokens(cfg, s=16, seed=4))
    full, _ = tfm.forward(tp, toks, cfg)
    lg_prefill, cache = tfm.prefill(tp, toks[:, :-1], cfg)
    cache_full = tfm.init_cache(cfg, 2, 24, device="cpu")
    for key in ("k", "v"):
        cache_full[key][:, :, :15] = cache[key]
    lg_decode, _ = tfm.decode_step(tp, cache_full, toks[:, -1],
                                   torch.full((2,), 15, dtype=torch.int32), cfg)
    np.testing.assert_allclose(lg_decode.numpy(), full[:, -1].numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lg_prefill.numpy(), full[:, -2].numpy(), rtol=2e-2, atol=2e-2)


def test_decode_step_writes_the_cache_in_place():
    jcfg, cfg = _cfgs()
    _, tp = _weights(jcfg)
    cache = tfm.init_cache(cfg, 2, 8, device="cpu")
    k_before = cache["k"]
    _, out = tfm.decode_step(tp, cache, torch.tensor([1, 2]), torch.tensor([0, 3]), cfg)
    assert out is cache and out["k"] is k_before
    written = cache["k"].abs().sum(dim=(0, 3, 4))       # (B, S)
    assert written[0, 0] > 0 and written[1, 3] > 0
    assert written[0, 1:].sum() == 0 and written[1, :3].sum() == 0


# ----------------------------------------------------------------- weights --

def test_init_lm_has_the_jax_tree():
    jcfg, cfg = _cfgs()
    jtree = jax.tree.map(np.asarray, jax_tfm.init_lm(jax.random.PRNGKey(0), jcfg))
    tree = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    jflat, flat = jax_export._flatten_named(jtree), export.flatten_named(tree)
    assert sorted(flat) == sorted(jflat)
    for name, arr in flat.items():
        assert arr.shape == jflat[name].shape and arr.dtype == jflat[name].dtype, name
    assert flat["layers/attn/wq"].shape == (cfg.n_layers, 64, 64)
    assert abs(flat["embed"].std() - 0.02) < 0.002
    assert abs(flat["layers/mlp/w_down"].std() - 128 ** -0.5) < 0.01
    np.testing.assert_array_equal(flat["layers/attn/q_norm"], 1.0)
    again = export.flatten_named(tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu"))
    for name in flat:
        np.testing.assert_array_equal(again[name], flat[name])
    full = get_config("qwen3-0.6b")   # every tensor of the full-width tree
    n = sum(np.prod(a.shape) for a in jax.tree.leaves(
        jax.eval_shape(lambda: jax_tfm.init_lm(jax.random.PRNGKey(0), jax_get_config("qwen3-0.6b")))))
    assert n == 596_049_920 and full.n_params() == 595_984_384   # + norms


def test_lm_tree_round_trips_through_export():
    jcfg, cfg = _cfgs(250)
    jp, tp = _weights(jcfg)
    toks = _tokens(cfg)
    want, _ = jax_tfm.forward(jp, jnp.asarray(toks), jcfg)
    # JAX writes, the port reads, through unflatten + params_from_numpy
    flat, header = export.loads(jax_export.dumps(jp, model="qwen3-0.6b-smoke"))
    assert header["model"] == "qwen3-0.6b-smoke" and "layers/attn/wq" in flat
    got, _ = tfm.forward(tfm.params_from_numpy(export.unflatten(flat), "cpu"), _t(toks), cfg)
    np.testing.assert_array_equal(got.numpy(), tfm.forward(tp, _t(toks), cfg)[0].numpy())
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # the port writes, the JAX package reads, tensor for tensor
    jflat, _ = jax_export.loads(export.dumps(tp))
    for name, arr in export.flatten_named(tp).items():
        np.testing.assert_array_equal(jflat[name], arr)


def test_params_from_numpy_keeps_bfloat16():
    jtree = jax_tfm.init_lm(jax.random.PRNGKey(1), dataclasses.replace(
        _cfgs()[0], dtype="bfloat16"))
    tree = tfm.params_from_numpy(jax.tree.map(np.asarray, jtree), "cpu")
    assert tree["layers"]["attn"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["embed"].float().numpy(),
                                  np.asarray(jtree["embed"].astype(jnp.float32)))


@pytest.mark.parametrize("change,error", [
    pytest.param({"attn_impl": "dense"}, ValueError, id="change1-ValueError"),
])
def test_options_not_ported_raise(change, error):
    jcfg, cfg = _cfgs()
    _, tp = _weights(jcfg)
    with pytest.raises(error):
        tfm.forward(tp, _t(_tokens(cfg)), dataclasses.replace(cfg, **change))


def test_moe_config_raises():
    """The name is historical: an MoE config once raised here, and then its
    int8 KV cache. Both now build and run (``models/moe.py``, its parity
    ``tests/test_torch_moe.py``; the cache's ``tests/test_torch_kv_int8.py``)."""
    from repro_torch.configs import MoESpec
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                              moe=MoESpec(n_routed=8, top_k=2, n_shared=1, d_expert=32))
    params = tfm.init_lm(cfg, torch.Generator(), "cpu")
    assert "moe" in params["layers"] and "mlp" not in params["layers"]
    logits, aux = tfm.forward(params, _t(_tokens(cfg)), cfg)
    assert bool(torch.isfinite(logits).all()) and float(aux) > 0
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    assert export.flatten_named(tfm.init_lm(cfgq, torch.Generator(), "cpu")).keys() == \
        export.flatten_named(params).keys()
    cache = tfm.init_cache(cfgq, 2, 16, device="cpu")
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float32
    lg, cache = tfm.decode_step(params, cache, torch.tensor([1, 2]),
                                torch.tensor([0, 3], dtype=torch.int32), cfgq)
    assert tuple(lg.shape) == (2, cfg.vocab_padded) and bool(torch.isfinite(lg).all())
    assert bool((cache["k_scale"][:, [0, 1], [0, 3]] > 0).all())
