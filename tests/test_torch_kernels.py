"""The port's conv kernel module against the JAX package's Pallas kernel.

On the CPU the wrapper runs the plain PyTorch version; it is held against
the Pallas kernel in interpret mode and against the jnp oracle on the
``tests/test_kernels.py`` sweep plus a ragged batch (B=3), and on inputs
holding NaN and +-inf (NaN positions equal). A numpy model of the float32
route's 3xTF32 arithmetic (operands rounded to TF32 as ``cvt.rna`` rounds,
three passes, the non-finite rule) is held against the plain version at
the float32 gate, and one TF32 pass is shown to miss it. The ``cuda``-
marked tests hold the CUDA kernel itself against the plain version and skip
where no card is present (``chip_smoke.py`` does the same at every main-path
shape). The JAX side is imported by a fixture, so that the card-only tests
also run on a machine with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ops as kops, sm_cnn_conv
from repro_torch.models import sm_cnn

SHAPES = [
    (8, 64, 50, 5, 100),    # the paper's config
    (4, 16, 8, 3, 12),
    (16, 32, 16, 7, 32),
    (2, 8, 4, 2, 8),
    (3, 64, 50, 5, 100),    # ragged: no B % 8 condition in the port
]
# the CUDA kernel is compiled for sm-cnn's width (w=5) only
CUDA_SHAPES = [sh for sh in SHAPES if sh[3] in sm_cnn_conv.KERNEL_WIDTHS] + [
    (8, 16, 8, 5, 12),
    (256, 64, 50, 5, 100),   # the local plan's top bucket
] + [
    # the float32 kernel's tile edges: windows (n8 tiles, chunks of 72),
    # filters (m16 tiles, the bank padded to 8), the embedding pad (k8), the
    # persistent grid
    (4, 1, 50, 5, 100),      # S=1: 5 windows, one tile
    (4, 13, 50, 5, 100),     # 17 windows, not a multiple of 8
    (4, 64, 50, 5, 8),       # F: half a filter tile
    (4, 64, 50, 5, 9),
    (4, 64, 50, 5, 105),     # past 104
    (4, 64, 50, 5, 113),     # past 112: 8 filter tiles for 7 teams
    (4, 64, 8, 5, 100),      # d: one k8 step
    (4, 64, 57, 5, 100),     # past the pad of 56
    (133, 64, 50, 5, 100),   # more samples than 132 SMs hold blocks
    (4, 69, 50, 5, 100),     # 10 window tiles: a second chunk, moved back to end at the last
    (2, 141, 50, 5, 100),    # 19 window tiles: three chunks
    (2, 180, 50, 5, 100),    # the longest S the float32 kernel takes at this d and F
]
#: inputs with NaN and +-inf: the paper's width and a small one
NONFINITE_SHAPES = [(8, 64, 50, 5, 100), (4, 16, 8, 3, 12)]
DTYPES = [("float32", 1e-5), ("bfloat16", 2e-2)]


def _inputs(b, s, d, w, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    # pre-activations of std 0.3 keep tanh off its saturation, so the
    # outputs spread over (-1, 1) and the tolerances bite
    filt = (rng.standard_normal((w * d, f)) * (0.3 / np.sqrt(w * d))).astype(np.float32)
    bias = (rng.standard_normal((f,)) * 0.1).astype(np.float32)
    return x, filt, bias


def _nonfinite_inputs(b, s, d, w, f, seed=0):
    """``_inputs`` with a NaN in sample 0, +inf at the first row and -inf at
    the last row of sample 1, and a NaN in the last filter column."""
    x, filt, bias = _inputs(b, s, d, w, f, seed)
    x[0, s // 2, 1 % d] = np.nan
    x[1, 0, 2 % d] = np.inf
    x[1, s - 1, 0] = -np.inf
    filt[3 % (w * d), f - 1] = np.nan
    return x, filt, bias


def _assert_nonfinite_result(got):
    """What the non-finite inputs give in float32 and in JAX: sample 0 and
    the last filter NaN everywhere, every other entry finite, and the
    infinite pre-activations of sample 1 reaching tanh as +1."""
    assert np.isnan(got[0]).all() and np.isnan(got[:, -1]).all()
    assert np.isfinite(got[1:, :-1]).all()
    assert (got[1, :-1] == 1.0).any()


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


def _conv_tf32_model(x, filt, bias, w, passes=3):
    """The conv as the float32 kernel computes it: im2col rows and filters
    split into TF32 parts, products exact (two TF32 mantissas fit float32's),
    sums in float32: ``lo*hi + hi*lo + hi*hi`` with 3 passes, ``hi*hi``
    alone with 1; then + bias, tanh and a NaN-propagating max."""
    s = x.shape[1]
    n_win = s + w - 1
    xp = np.pad(x, ((0, 0), (w - 1, w - 1), (0, 0)))
    cols = np.concatenate([xp[:, j:j + n_win, :] for j in range(w)], axis=-1)
    (ah, ahc, al), (bh, bhc, bl) = _split(cols), _split(filt)

    def mm(a, b):
        return torch.from_numpy(np.ascontiguousarray(a)) @ torch.from_numpy(b)

    acc = mm(ah, bh) if passes == 1 else (mm(al, bhc) + mm(ahc, bl)) + mm(ah, bh)
    return torch.tanh(acc + torch.from_numpy(bias)).amax(dim=1).numpy()


def _plain(x, filt, bias, w):
    return sm_cnn_conv.conv_tanh_maxpool_plain(
        torch.from_numpy(x), torch.from_numpy(filt), torch.from_numpy(bias), w).numpy()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config, reduced as jax_reduced
    from repro.kernels import ops as jax_kops, ref as jax_ref
    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=jax_get_config,
                                 reduced=jax_reduced, kops=jax_kops, ref=jax_ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,s,d,w,f", SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_plain_conv_matches_pallas_and_oracle(ref, b, s, d, w, f, dtype, tol):
    jnp = ref.jnp
    x, filt, bias = _inputs(b, s, d, w, f)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jf, jb = (jnp.asarray(a).astype(jdt) for a in (x, filt, bias))
    pallas = ref.kops.conv_tanh_maxpool(jx, jf, jb, w, interpret=True)
    oracle = ref.ref.conv_tanh_maxpool_ref(jx, jf, jb, w)
    tx, tf, tb = (torch.from_numpy(a).to(tdt) for a in (x, filt, bias))
    before = sm_cnn_conv.launches
    got = sm_cnn_conv.conv_tanh_maxpool(tx, tf, tb, w)
    assert sm_cnn_conv.launches == before   # the CPU path launches nothing
    assert got.dtype == tdt and tuple(got.shape) == (b, f)
    got = got.float().numpy()
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("full", [False, True])
def test_sm_cnn_score_matches_pallas_backend(ref, full):
    jcfg = ref.get_config("sm-cnn")
    jcfg = jcfg if full else ref.reduced(jcfg)
    cfg = get_config("sm-cnn") if full else reduced(get_config("sm-cnn"))
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=3)
    rng = np.random.default_rng(4)
    b = 3
    q = rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    a = rng.integers(0, cfg.vocab_size, (b, cfg.max_len)).astype(np.int32)
    q[:, cfg.max_len // 2:] = 0    # PAD ids gather embed[0] in both packages
    feats = rng.random((b, 4)).astype(np.float32)
    want = ref.kops.sm_cnn_score(ref.jax.tree.map(ref.jnp.asarray, tree), q, a,
                                 feats, jcfg, interpret=True)
    got = kops.sm_cnn_score(sm_cnn.params_from_numpy(tree, "cpu"),
                            torch.from_numpy(q), torch.from_numpy(a),
                            torch.from_numpy(feats), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("b,s,d,w,f", NONFINITE_SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_plain_conv_propagates_nan_as_pallas_and_oracle(ref, b, s, d, w, f, dtype, tol):
    jnp = ref.jnp
    x, filt, bias = _nonfinite_inputs(b, s, d, w, f)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jf, jb = (jnp.asarray(a).astype(jdt) for a in (x, filt, bias))
    pallas = ref.kops.conv_tanh_maxpool(jx, jf, jb, w, interpret=True)
    oracle = ref.ref.conv_tanh_maxpool_ref(jx, jf, jb, w)
    tx, tf, tb = (torch.from_numpy(a).to(tdt) for a in (x, filt, bias))
    got = sm_cnn_conv.conv_tanh_maxpool(tx, tf, tb, w).float().numpy()
    _assert_nonfinite_result(got)
    for want in (pallas, oracle):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,d,w,f", SHAPES)
def test_3xtf32_model_meets_the_float32_gate(b, s, d, w, f):
    x, filt, bias = _inputs(b, s, d, w, f)
    np.testing.assert_allclose(_conv_tf32_model(x, filt, bias, w),
                               _plain(x, filt, bias, w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,d,w,f", NONFINITE_SHAPES)
def test_3xtf32_model_follows_float32_on_nonfinite_inputs(b, s, d, w, f):
    x, filt, bias = _nonfinite_inputs(b, s, d, w, f)
    got, want = _conv_tf32_model(x, filt, bias, w), _plain(x, filt, bias, w)
    _assert_nonfinite_result(got)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_one_tf32_pass_misses_the_float32_gate():
    """Why the kernel runs three passes: one TF32 product a term leaves
    ~1e-4 at sm-cnn's width, ten times the gate; the split is ~1e-7."""
    x, filt, bias = _inputs(8, 64, 50, 5, 100)
    want = _plain(x, filt, bias, 5)
    one = np.abs(_conv_tf32_model(x, filt, bias, 5, passes=1) - want).max()
    three = np.abs(_conv_tf32_model(x, filt, bias, 5) - want).max()
    assert one > 1e-5 and three <= 1e-5
    assert three < one / 10


def _good():
    x, filt, bias = _inputs(2, 8, 4, 3, 6)
    return torch.from_numpy(x), torch.from_numpy(filt), torch.from_numpy(bias)


@pytest.mark.parametrize("case", [
    "float64", "mixed_dtype", "rank", "filter_rows", "bias_shape",
    "non_contiguous", "width",
])
def test_wrapper_refuses_bad_inputs(case):
    x, filt, bias = _good()
    w = 3
    if case == "float64":
        x, filt, bias = x.double(), filt.double(), bias.double()
    elif case == "mixed_dtype":
        filt = filt.to(torch.bfloat16)
    elif case == "rank":
        x = x[0]
    elif case == "filter_rows":
        filt = filt[:-1]
    elif case == "bias_shape":
        bias = bias[:-1]
    elif case == "non_contiguous":
        x = x.transpose(0, 1)
    elif case == "width":
        w = 0
        filt = torch.zeros((0, filt.shape[1]))
    with pytest.raises((ValueError, TypeError)):
        sm_cnn_conv.conv_tanh_maxpool(x, filt, bias, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,d,w,f", CUDA_SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_kernel_matches_plain(cuda_device, b, s, d, w, f, dtype, tol):
    tdt = getattr(torch, dtype)
    x, filt, bias = (torch.from_numpy(a).to(cuda_device, tdt)
                     for a in _inputs(b, s, d, w, f))
    before = sm_cnn_conv.launches
    got = sm_cnn_conv.conv_tanh_maxpool(x, filt, bias, w)
    torch.cuda.synchronize()
    assert sm_cnn_conv.launches == before + 1
    want = sm_cnn_conv.conv_tanh_maxpool_plain(x, filt, bias, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("moved", ["x", "filters"])
def test_cuda_kernel_takes_inputs_off_16_byte_alignment(cuda_device, moved):
    """The float32 kernel copies by cp.async.bulk only from 16-byte aligned
    addresses; a contiguous view 4 bytes further on takes its 4-byte copies."""
    arrays = dict(zip(("x", "filters", "bias"), _inputs(8, 64, 50, 5, 100)))
    t = {k: torch.from_numpy(a).to(cuda_device) for k, a in arrays.items()}
    a = arrays[moved]
    flat = torch.empty(a.size + 1, device=cuda_device)
    t[moved] = flat[1:].view(a.shape)
    t[moved].copy_(torch.from_numpy(a))
    assert t[moved].data_ptr() % 16 == 4
    got = sm_cnn_conv.conv_tanh_maxpool(t["x"], t["filters"], t["bias"], 5)
    want = sm_cnn_conv.conv_tanh_maxpool_plain(t["x"], t["filters"], t["bias"], 5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_kernel_propagates_nan_as_plain(cuda_device, dtype, tol):
    tdt = getattr(torch, dtype)
    for b, s, d, w, f in NONFINITE_SHAPES:
        if w not in sm_cnn_conv.KERNEL_WIDTHS:
            continue
        x, filt, bias = (torch.from_numpy(a).to(cuda_device, tdt)
                         for a in _nonfinite_inputs(b, s, d, w, f))
        got = sm_cnn_conv.conv_tanh_maxpool(x, filt, bias, w).float()
        want = sm_cnn_conv.conv_tanh_maxpool_plain(x, filt, bias, w).float()
        torch.cuda.synchronize()
        _assert_nonfinite_result(got.cpu().numpy())
        assert torch.equal(got.isnan(), want.isnan())
        torch.testing.assert_close(got, want, rtol=tol, atol=tol, equal_nan=True)


@pytest.mark.cuda
def test_cuda_routes_report_their_design(cuda_device):
    f32 = sm_cnn_conv.route_info(torch.float32)
    bf16 = sm_cnn_conv.route_info(torch.bfloat16)
    assert f32["design"] == "3xTF32 mma.sync + cp.async"
    assert bf16["design"] == "CUDA-core FMA"
    assert bf16["local_bytes"] == 0
    for info in (f32, bf16):
        assert info["blocks_per_sm"] >= 1
    # sm-cnn's shape: the filter bank as in memory (250 x 100) and the zeros
    # that fragments read past it (to row 255, filter 111), the raw sample
    # (64 x 50), the split tile (72 windows + 4 rows, (hi, lo) at 56
    # columns), and the sums of the second warp of 7 teams; 14 warps; the
    # copies' 6 mbarriers
    assert f32["dynamic_smem"] == 4 * ((255 * 100 + 112) + 64 * 50 + 76 * 112 + 7 * 32 * 9)
    assert f32["static_smem"] == 6 * 8
    assert f32["threads"] == 14 * 32
    assert f32["local_bytes"] == 0
    for info in (f32, bf16):
        assert info["static_smem"] + info["dynamic_smem"] <= info["smem_limit"]
        assert info["sms"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_route_info_leaves_larger_shapes_launchable(cuda_device, dtype, tol):
    """A route query at a small shape must leave a launch at a shape that
    needs more shared memory launchable."""
    tdt = getattr(torch, dtype)
    sm_cnn_conv.route_info(tdt, 1, 8, 8)
    sm_cnn_conv.route_info(tdt)
    x, filt, bias = (torch.from_numpy(a).to(cuda_device, tdt)
                     for a in _inputs(4, 64, 57, 5, 100))
    got = sm_cnn_conv.conv_tanh_maxpool(x, filt, bias, 5)
    want = sm_cnn_conv.conv_tanh_maxpool_plain(x, filt, bias, 5)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("s,d", [(2000, 50), (64, 400), (181, 50)])
def test_cuda_kernel_refuses_a_shape_past_shared_memory(cuda_device, s, d):
    x, filt, bias = (torch.from_numpy(a).to(cuda_device) for a in _inputs(1, s, d, 5, 100))
    before = sm_cnn_conv.launches
    with pytest.raises(ValueError, match="bytes of shared memory"):
        sm_cnn_conv.conv_tanh_maxpool(x, filt, bias, 5)
    assert sm_cnn_conv.launches == before


@pytest.mark.cuda
def test_cuda_kernel_refuses_an_uncompiled_width(cuda_device):
    x, filt, bias = (torch.from_numpy(a).to(cuda_device) for a in _inputs(2, 8, 4, 3, 6))
    before = sm_cnn_conv.launches
    with pytest.raises(ValueError, match="compiled for filter widths"):
        sm_cnn_conv.conv_tanh_maxpool(x, filt, bias, 3)
    assert sm_cnn_conv.launches == before


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_cpu_filter(cuda_device):
    x, filt, bias = (torch.from_numpy(a) for a in _inputs(2, 8, 4, 3, 6))
    with pytest.raises(ValueError, match="devices differ"):
        sm_cnn_conv.conv_tanh_maxpool(x.to(cuda_device), filt, bias.to(cuda_device), 3)
