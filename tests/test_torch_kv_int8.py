"""The port's int8 KV cache (``cfg.kv_quant``) against the JAX package's.

``repro_torch.models.transformer``'s ``_kv_quantize``, ``_kv_dequantize``,
``init_cache`` and the quantized branch of ``decode_step`` against
``repro.models.transformer``'s on the same numpy-seeded inputs, on the CPU:

* quantize and dequantize bit for bit in float32 and bfloat16, with an
  all-zero row (the 1e-8 floor), values at +-127 and at the .5 rounding
  boundaries (half to even, as ``jnp.round``);
* ``init_cache``: shapes, dtypes and zeros as JAX's, ``dtype`` ignored;
* one ``decode_step`` on reduced qwen3-0.6b and on reduced
  deepseek-moe-16b (capacity factor 16, as ``tests/test_arch_smoke.py``),
  float32, after a prefill cache that both sides quantize: every cache
  entry the step does not write equal to JAX's, the written rows' int8
  values at most one step off where the two sides' float32 K/V differ in
  their last bits (counted and bounded), their scales and the logits at
  ``tests/test_torch_lm.py``'s tolerance;
* 16 steps from an empty int8 cache against ``forward``: top-1 identical
  and ``atol=0.15``, ``tests/test_arch_smoke.py::test_int8_kv_cache_decode_agreement``'s
  bound; the in-place writes touch only ``[layer, b, pos[b]]``; ``prefill``
  and ``forward`` ignore ``kv_quant``.

The ``cuda``-marked test holds the quantizer on the card against the CPU
and skips where no card is present. The JAX side is imported by a fixture,
so that it runs on a machine with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kv_int8.py
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import transformer as tfm

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("qwen3-0.6b", "deepseek-moe-16b")
#: of the int8 values a decode step writes, the share that may be one step
#: off JAX's (a float32 K/V value on a rounding boundary on one side only)
OFF_BY_ONE_SHARE = 0.01


@pytest.fixture(scope="module")
def J():
    """The JAX package's side of the comparison, and a cache of its
    weights shared by the file's tests."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config, reduced as jax_reduced
    from repro.models import transformer as jax_tfm
    return types.SimpleNamespace(jax=jax, jnp=jnp, tfm=jax_tfm, get_config=jax_get_config,
                                 reduced=jax_reduced, cache={})


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    """A tensor or a JAX array as numpy bits (bfloat16 as its uint16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.uint16).view(np.int16) if a.dtype.name == "bfloat16" else a


def _cfgs(J, arch, kv_quant=True):
    """The reduced config in both packages (remat off in JAX: the port does
    not rematerialise), an MoE at capacity factor 16 so that no slot drops."""
    jcfg = dataclasses.replace(J.reduced(J.get_config(arch)), remat=False, kv_quant=kv_quant)
    cfg = dataclasses.replace(reduced(get_config(arch)), kv_quant=kv_quant)
    if cfg.moe is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=16.0))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    return jcfg, cfg


def _weights(J, arch):
    """JAX parameters and the port's copy of them (``params_from_numpy``)."""
    if arch not in J.cache:
        jcfg, _ = _cfgs(J, arch)
        jp = J.tfm.init_lm(J.jax.random.PRNGKey(0), jcfg)
        J.cache[arch] = jp, tfm.params_from_numpy(J.jax.tree.map(np.asarray, jp), "cpu")
    return J.cache[arch]


def _tokens(cfg, b=2, s=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _kv_inputs(seed=0):
    """(4, 64, 8, 128) float32 K/V-like rows at several scales, with an
    all-zero row, a row at +-127 exactly, and rows whose quotients fall
    on the .5 boundaries."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, 64, 8, 128)).astype(np.float32)
    x *= rng.choice([1e-3, 0.1, 1.0, 30.0], size=(4, 64, 8, 1)).astype(np.float32)
    x[0, 0, 0] = 0.0                                   # the 1e-8 floor
    # absmax 127: scale 1.0, so the quotient is the value itself
    halves = np.arange(-127, 128, dtype=np.float32)[:128] + 0.5
    x[0, 1, 0] = np.clip(halves, -127, 127)
    x[0, 1, 0, 0] = 127.0
    x[0, 1, 1] = -np.clip(halves, -127, 127)
    x[0, 1, 1, 0] = -127.0
    x[0, 2, 0] = np.linspace(-127, 127, 128, dtype=np.float32)
    x[0, 2, 1] = np.where(np.arange(128) % 2, 2.5, -0.5).astype(np.float32)
    x[0, 2, 1, 0] = 127.0
    return x


# -------------------------------------------------------------- quantize --

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_match_jax_bit_for_bit(J, dtype):
    x = _kv_inputs()
    jx = J.jnp.asarray(x).astype(getattr(J.jnp, dtype))
    tx = _t(x).to(getattr(torch, dtype))
    np.testing.assert_array_equal(_bits(tx), _bits(jx))     # the same inputs
    jq, jscale = J.tfm._kv_quantize(jx)
    q, scale = tfm._kv_quantize(tx)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    assert tuple(q.shape) == x.shape and tuple(scale.shape) == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    for out in ("float32", "bfloat16"):
        got = tfm._kv_dequantize(q, scale, getattr(torch, out))
        want = J.tfm._kv_dequantize(jq, jscale, getattr(J.jnp, out))
        assert got.dtype == getattr(torch, out)
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # the boundaries: the floor, +-127, and half to even at scale 1
    assert scale[0, 0, 0].item() == np.float32(np.float32(1e-8) / np.float32(127.0))
    assert bool((q[0, 0, 0] == 0).all())
    assert scale[0, 1, 0].item() == 1.0 and q[0, 1, 0, 0].item() == 127
    assert q[0, 1, 1, 0].item() == -127
    np.testing.assert_array_equal(q[0, 2, 1, 1:].numpy(),
                                  np.where(np.arange(1, 128) % 2, 2, 0))
    np.testing.assert_array_equal(q[0, 1, 0, 1:4].numpy(), np.array([-126, -124, -124]))


def test_quantize_clips_and_rounds_half_to_even():
    """The port's formula against numpy's round-half-to-even, a row at
    absmax 127 (scale exactly 1.0) so every quotient is the value."""
    row = torch.tensor([127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5])
    q, scale = tfm._kv_quantize(row)
    assert scale.item() == 1.0
    np.testing.assert_array_equal(q.numpy(), np.round(row.numpy()).astype(np.int8))
    assert q.tolist() == [127, -127, 0, 2, 2, 0, -2, -2, 126, -126]


# ------------------------------------------------------------ init_cache --

@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(J, arch):
    jcfg, cfg = _cfgs(J, arch)
    jc = J.tfm.init_cache(jcfg, 3, 20, dtype=J.jnp.bfloat16)
    tc = tfm.init_cache(cfg, 3, 20, dtype=torch.bfloat16, device="cpu")
    assert sorted(tc) == sorted(jc) == ["k", "k_scale", "v", "v_scale"]
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).removeprefix("torch.") == jc[key].dtype.name, key
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]))
    assert tc["k"].shape == (cfg.n_layers, 3, 20, cfg.n_kv_heads, cfg.d_head)
    assert tc["k_scale"].shape == (cfg.n_layers, 3, 20, cfg.n_kv_heads)


# --------------------------------------------------------------- decode --

def _quantized_prefill(J, jcfg, cfg, jc, max_len):
    """JAX's prefill cache quantized into [0, S) of an int8 cache of
    ``max_len`` positions, by each package's own ``_kv_quantize``: the two
    caches are equal, so the step after them is all that differs."""
    s = jc["k"].shape[2]
    jcache = J.tfm.init_cache(jcfg, 2, max_len)
    tcache = tfm.init_cache(cfg, 2, max_len, device="cpu")
    for key in ("k", "v"):
        jq, jscale = J.tfm._kv_quantize(jc[key])
        q, scale = tfm._kv_quantize(_t(np.asarray(jc[key])))
        jcache[key] = jcache[key].at[:, :, :s].set(jq)
        jcache[f"{key}_scale"] = jcache[f"{key}_scale"].at[:, :, :s].set(jscale)
        tcache[key][:, :, :s] = q
        tcache[f"{key}_scale"][:, :, :s] = scale
    for key in tcache:
        np.testing.assert_array_equal(tcache[key].numpy(), np.asarray(jcache[key]))
    return jcache, tcache


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(J, arch):
    jcfg, cfg = _cfgs(J, arch)
    jp, tp = _weights(J, arch)
    toks = _tokens(cfg)
    _, jc = J.tfm.prefill(jp, J.jnp.asarray(toks), jcfg)
    jcache, tcache = _quantized_prefill(J, jcfg, cfg, jc, 16)
    new, pos = np.array([3, 7], np.int32), np.array([12, 9], np.int32)
    jl, jcache = J.tfm.decode_step(jp, jcache, J.jnp.asarray(new), J.jnp.asarray(pos), jcfg)
    tl, tcache = tfm.decode_step(tp, tcache, _t(new), _t(pos), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    written = np.zeros(tcache["k_scale"].shape, bool)
    written[:, [0, 1], pos] = True
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


@pytest.mark.parametrize("arch", ARCHS)
def test_sixteen_steps_from_an_empty_cache_match_forward(J, arch):
    """``tests/test_arch_smoke.py::test_int8_kv_cache_decode_agreement``
    for the port (top-1 identical, ``atol=0.15``), and the port's last
    logits and cache against the same 16 JAX steps."""
    jcfg, cfg = _cfgs(J, arch)
    jp, tp = _weights(J, arch)
    toks = _tokens(cfg, s=16, seed=2)
    full, _ = tfm.forward(tp, _t(toks), dataclasses.replace(cfg, kv_quant=False))
    cache = tfm.init_cache(cfg, 2, 24, device="cpu")
    jcache = J.tfm.init_cache(jcfg, 2, 24)
    jstep = J.jax.jit(J.tfm.decode_step, static_argnums=4)
    for t in range(16):
        pos = np.full((2,), t, np.int32)
        lg, cache = tfm.decode_step(tp, cache, _t(toks[:, t]), _t(pos), cfg)
        jl, jcache = jstep(jp, jcache, J.jnp.asarray(toks[:, t]), J.jnp.asarray(pos), jcfg)
    ref = full[:, -1].numpy()
    np.testing.assert_array_equal(lg.numpy().argmax(-1), ref.argmax(-1))
    np.testing.assert_allclose(lg.numpy(), ref, atol=0.15)
    assert cache["k"].dtype == torch.int8
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    for key in ("k", "v"):
        diff = np.abs(cache[key].numpy().astype(np.int32)
                      - np.asarray(jcache[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff == 1).mean() <= OFF_BY_ONE_SHARE, key
        np.testing.assert_allclose(cache[f"{key}_scale"].numpy(),
                                   np.asarray(jcache[f"{key}_scale"]), **TOL)


def test_decode_writes_only_its_rows():
    """Every entry of the four tensors but ``[layer, b, pos[b]]`` keeps its
    value; each written entry is the quantized new row."""
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")), kv_quant=True)
    tp = tfm.init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    cache = tfm.init_cache(cfg, 3, 10, device="cpu")
    gen = torch.Generator().manual_seed(4)
    for key in ("k", "v"):
        cache[key].copy_(torch.randint(-127, 128, cache[key].shape, generator=gen))
        cache[f"{key}_scale"].copy_(torch.rand(cache[f"{key}_scale"].shape, generator=gen))
    before = {k: v.clone() for k, v in cache.items()}
    pos = torch.tensor([0, 9, 4], dtype=torch.int32)
    _, out = tfm.decode_step(tp, cache, torch.tensor([1, 2, 3]), pos, cfg)
    assert out is cache
    written = torch.zeros(cache["k_scale"].shape, dtype=torch.bool)
    written[:, torch.arange(3), pos.long()] = True
    for key, t in cache.items():
        assert torch.equal(t[~written], before[key][~written]), key
        assert not torch.equal(t[written], before[key][written]), key
    # a written row is a quantized row: its absmax is 127 and its scale > 0
    rows = cache["k"][written]
    assert bool((rows.abs().amax(-1) == 127).all())
    assert bool((cache["k_scale"][written] > 0).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_forward_ignore_kv_quant(arch):
    cfg = reduced(get_config(arch))
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    tp = tfm.init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = _t(_tokens(cfg, s=10, seed=3))
    for a, b in zip(tfm.forward(tp, toks, cfg), tfm.forward(tp, toks, cfgq)):
        assert torch.equal(a, b)
    (l0, c0), (l1, c1) = tfm.prefill(tp, toks, cfg), tfm.prefill(tp, toks, cfgq)
    assert torch.equal(l0, l1) and sorted(c1) == ["k", "v"]
    for key in ("k", "v"):
        assert c1[key].dtype == torch.float32 and torch.equal(c0[key], c1[key])


# ------------------------------------------------------------------ card --

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_quantize_matches_the_cpu(cuda_device, dtype):
    x = _t(_kv_inputs(seed=5)).to(getattr(torch, dtype))
    q, scale = tfm._kv_quantize(x)
    cq, cscale = tfm._kv_quantize(x.to(cuda_device))
    assert cq.device.type == "cuda"
    assert torch.equal(cq.cpu(), q) and torch.equal(cscale.cpu(), scale)
    for out in (torch.float32, torch.bfloat16):
        assert torch.equal(tfm._kv_dequantize(cq, cscale, out).cpu(),
                           tfm._kv_dequantize(q, scale, out))
