"""The port's conv kernel module against the JAX package's Pallas kernel.

On the CPU the wrapper runs the plain PyTorch version; it is held against
the Pallas kernel in interpret mode and against the jnp oracle on the
``tests/test_kernels.py`` sweep plus a ragged batch (B=3). The ``cuda``-
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
]
DTYPES = [("float32", 1e-5), ("bfloat16", 2e-2)]


def _inputs(b, s, d, w, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    # pre-activations of std 0.3 keep tanh off its saturation, so the
    # outputs spread over (-1, 1) and the tolerances bite
    filt = (rng.standard_normal((w * d, f)) * (0.3 / np.sqrt(w * d))).astype(np.float32)
    bias = (rng.standard_normal((f,)) * 0.1).astype(np.float32)
    return x, filt, bias


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
