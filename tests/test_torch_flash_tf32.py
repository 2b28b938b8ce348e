"""A numpy model of the float32 attention kernels' 3xTF32 arithmetic against
the JAX package.

The float32 routes of ``csrc/flash_attention.cu`` (the forward, ``wgmma``)
and ``csrc/flash_attention_bwd.cu`` (dk/dv and dq, ``mma.sync``) run every
product on the tensor cores in TF32: each operand is split v = hi + lo,
both rounded as ``cvt.rna.tf32.f32`` rounds, and three passes, lo*hi +
hi*lo + hi*hi, sum into float32. The softmax, lse and delta stay float32.
That arithmetic cannot run here, so this file models it: the same split
(``_tf32`` and ``_split``, copied from ``tests/test_torch_kernels.py``,
since test files are not a package), products exact (two TF32 mantissas
fit float32's) and sums in float32, for the forward (out, lse) and the
backward (dq, dk, dv), with P and dS split as the kernels split them.

The model is held to ``repro.models.layers.flash_attention_jnp`` and its
custom VJP at S 1, 17 and 130 and G 1, 2 and 8 query heads a KV head at
d = 128, at the float32 gates of the card's checks: the forward 2e-5 by
max abs error and by error norm, lse 2e-5, the backward rtol/atol 1e-4
element by element and 2e-5 by error norm. One TF32 pass a product misses
those gates, which is why the kernels run three. Inputs holding +-inf and
NaN in q follow float32, not the split: NaN where JAX gives NaN, the
rest at the gate.
"""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

LENGTHS = [1, 17, 130]
GROUPS = [1, 2, 8]
D = 128
HKV = 2
MASK = -1e30
FWD_TOL = 2e-5
LSE_TOL = 2e-5
BWD_TOL = (1e-4, 1e-4, 2e-5)
#: a gradient whose RMS is below this is rounding, not signal
RMS_FLOOR = 1e-3


def _tf32(a):
    """float32 -> TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest, ties
    away from zero (add 0x1000 to the magnitude, clear the low 13 bits of
    the mantissa); inf and NaN stay as they are."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    r = ((a.view(np.int32) + 0x1000) & ~0x1FFF).view(np.float32)
    return np.where(np.isfinite(a), r, a)


def _split(v):
    """v = hi + lo in TF32, with the non-finite rule of the float32 kernel:
    (hi, hi where v is finite else 0, lo where v is finite else 0)."""
    hi = _tf32(v)
    finite = np.isfinite(v)
    with np.errstate(invalid="ignore"):
        lo = _tf32(np.where(finite, v - hi, 0))
    return hi, np.where(finite, hi, 0).astype(np.float32), np.where(finite, lo, 0)


def _mm(a, b, passes=3):
    """a @ b (batched, float32) as the kernels' products compute it: with 3
    passes lo*hi + hi*lo + hi*hi, the small terms first; with 1, hi*hi."""
    (ah, ahc, al), (bh, bhc, bl) = _split(a), _split(b)

    def mm(x, y):
        return torch.from_numpy(np.ascontiguousarray(x)) @ torch.from_numpy(
            np.ascontiguousarray(y))

    if passes == 1:
        return mm(ah, bh).numpy()
    return ((mm(al, bhc) + mm(ahc, bl)) + mm(ah, bh)).numpy()


def _heads(q, k, v):
    """(B, S, H, d), (B, S, Hkv, d) -> (B, Hkv, G, S, d), (B, Hkv, 1, S, d):
    query head h reads KV head h // G."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).transpose(0, 2, 3, 1, 4)
    return qg, k.transpose(0, 2, 1, 3)[:, :, None], v.transpose(0, 2, 1, 3)[:, :, None]


def _scores(qg, kg, passes):
    """Scaled scores, -1e30 past each row's position: (B, Hkv, G, S, S)."""
    s = qg.shape[3]
    sc = _mm(qg, np.swapaxes(kg, -1, -2), passes) * np.float32(1 / math.sqrt(qg.shape[-1]))
    causal = np.arange(s)[None, :] <= np.arange(s)[:, None]
    return np.where(causal, sc, np.float32(MASK)).astype(np.float32)


def model_fwd(q, k, v, passes=3):
    """The forward kernel's arithmetic: (out (B, S, H, d), lse (B, H, S))."""
    b, s, h, d = q.shape
    qg, kg, vg = _heads(q, k, v)
    with np.errstate(invalid="ignore", over="ignore"):
        sc = _scores(qg, kg, passes)
        m = sc.max(-1, keepdims=True)
        p = np.exp(sc - m)
        l = np.maximum(p.sum(-1, keepdims=True), np.float32(1e-30))
        out = _mm(p, vg, passes) / l
        lse = (m + np.log(l))[..., 0]
    return (out.transpose(0, 3, 1, 2, 4).reshape(b, s, h, d).astype(np.float32),
            lse.reshape(b, h, s).astype(np.float32))


def model_bwd(q, k, v, out, lse, dout, passes=3):
    """The backward kernels' arithmetic (FlashAttention-2's rule):
    (dq, dk, dv) in the inputs' layouts."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    qg, kg, vg = _heads(q, k, v)
    dog = dout.reshape(b, s, hkv, g, d).transpose(0, 2, 3, 1, 4)
    og = out.reshape(b, s, hkv, g, d).transpose(0, 2, 3, 1, 4)
    delta = (dog * og).sum(-1, dtype=np.float32)[..., None]
    causal = np.arange(s)[None, :] <= np.arange(s)[:, None]
    p = np.where(causal, np.exp(_scores(qg, kg, passes) - lse.reshape(b, hkv, g, s)[..., None]),
                 np.float32(0))
    dp = _mm(dog, np.swapaxes(vg, -1, -2), passes)
    ds = p * (dp - delta) * np.float32(1 / math.sqrt(d))
    dq = _mm(ds, kg, passes)
    # dk and dv sum over the G heads and the rows: one product over G * S
    def keys_by_rows(x):
        return np.swapaxes(x.reshape(b, hkv, g * s, s), -1, -2)

    dv = _mm(keys_by_rows(p), dog.reshape(b, hkv, g * s, d), passes)
    dk = _mm(keys_by_rows(ds), qg.reshape(b, hkv, g * s, d), passes)
    return (dq.transpose(0, 3, 1, 2, 4).reshape(b, s, h, d).astype(np.float32),
            dk.transpose(0, 2, 1, 3).astype(np.float32),
            dv.transpose(0, 2, 1, 3).astype(np.float32))


def _inputs(s, g, seed=0):
    rng = np.random.default_rng(seed)
    h = HKV * g
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((1, s, h, D), (1, s, HKV, D), (1, s, HKV, D), (1, s, h, D)))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's forward with its lse, and the VJP of
    ``flash_attention_jnp`` (its custom flash backward)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.models import layers

    def fwd(q, k, v):
        out, lse = layers._flash_fwd_impl(*(jnp.asarray(a) for a in (q, k, v)), 512)
        return np.asarray(out), np.asarray(lse).reshape(q.shape[0], q.shape[2], q.shape[1])

    def bwd(q, k, v, dout):
        _, vjp = jax.vjp(lambda *a: layers.flash_attention_jnp(*a, 512),
                         *(jnp.asarray(a) for a in (q, k, v)))
        return tuple(np.asarray(x) for x in vjp(jnp.asarray(dout)))

    return fwd, bwd


def _norm_err(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _fwd_err(got, want):
    return float(np.abs(got - want).max()), _norm_err(got, want)


def _bwd_ok(got, want):
    """The backward gate: rtol/atol element by element, and the error norm
    where the gradient is above rounding (dq at S=1 is rounding: one key,
    ds = p (dp - delta) = 0)."""
    rtol, atol, norm_tol = BWD_TOL
    ok = np.all(np.abs(got - want) <= atol + rtol * np.abs(want))
    if np.linalg.norm(want) > RMS_FLOOR * want.size ** 0.5:
        ok = ok and _norm_err(got, want) <= norm_tol
    return bool(ok)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("s", LENGTHS)
def test_3xtf32_forward_model_meets_the_float32_gate(ref, s, g):
    q, k, v, _ = _inputs(s, g)
    want_out, want_lse = ref[0](q, k, v)
    out, lse = model_fwd(q, k, v)
    err, rel = _fwd_err(out, want_out)
    assert err <= FWD_TOL and rel <= FWD_TOL, (err, rel)
    np.testing.assert_allclose(lse, want_lse, rtol=0, atol=LSE_TOL)


@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("s", LENGTHS)
def test_3xtf32_backward_model_meets_the_float32_gate(ref, s, g):
    q, k, v, dout = _inputs(s, g)
    out, lse = ref[0](q, k, v)
    want = ref[1](q, k, v, dout)
    got = model_bwd(q, k, v, out, lse, dout)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == w.shape, name
        assert _bwd_ok(x, w), (name, float(np.abs(x - w).max()), _norm_err(x, w))


def test_one_tf32_pass_misses_the_float32_gates(ref):
    """Why the kernels run three passes: one TF32 product a term (about
    2^-11 of each operand) leaves the forward and the gradients far outside
    their gates, where the split meets them."""
    q, k, v, dout = _inputs(130, 2, seed=3)
    want_out, _ = ref[0](q, k, v)
    one, three = _fwd_err(model_fwd(q, k, v, 1)[0], want_out), _fwd_err(
        model_fwd(q, k, v)[0], want_out)
    assert one[0] > 10 * FWD_TOL and one[1] > 10 * FWD_TOL
    assert three[0] <= FWD_TOL and three[1] <= FWD_TOL
    out, lse = ref[0](q, k, v)
    want = ref[1](q, k, v, dout)
    for x1, x3, w in zip(model_bwd(q, k, v, out, lse, dout, 1),
                         model_bwd(q, k, v, out, lse, dout), want):
        assert not _bwd_ok(x1, w) and _bwd_ok(x3, w)


def test_3xtf32_model_follows_float32_on_inf_and_nan_in_q(ref):
    """+-inf and NaN in q follow float32, not the split (for v = inf the
    split's lo is NaN): the rows they reach are NaN where JAX's are, every
    other value at the gate."""
    q, k, v, _ = _inputs(130, 2, seed=5)
    q[0, 5, 3, 7] = np.inf
    q[0, 40, 0, 0] = np.nan
    q[0, 90, 1, 2] = -np.inf
    want_out, want_lse = ref[0](q, k, v)
    out, lse = model_fwd(q, k, v)
    nan = np.isnan(want_out)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(out), nan)
    assert np.abs(out[~nan] - want_out[~nan]).max() <= FWD_TOL
    np.testing.assert_array_equal(np.isnan(lse), np.isnan(want_lse))
    finite = np.isfinite(want_lse)
    np.testing.assert_allclose(lse[finite], want_lse[finite], rtol=0, atol=LSE_TOL)
