"""The gradient of the port's causal GQA attention against the JAX package.

On the CPU: ``flash_attention_fwd_plain``'s log-sum-exp against the JAX
package's ``_flash_fwd_impl``; ``flash_attention_bwd_plain`` against
``jax.vjp`` of ``flash_attention_jnp`` (its custom VJP, the real flash
backward) and against torch autograd through ``flash_attention_plain``, for
1, 2 and 4 query heads a KV head and ragged lengths, at test_layers.py's
rtol/atol 1e-4; in bfloat16, within a rounding of the JAX rule; and
``FlashAttention`` (what ``flash_attention`` runs where grad is needed)
giving those gradients on the CPU.

The ``cuda``-marked tests hold the backward kernel of
``csrc/flash_attention_bwd.cu`` against the plain backward, and the forward
kernel's lse against the plain lse, at d=128 for lengths around the 64-key
tiles and the bfloat16 kernels' 128-key and 128-row blocks, 1 to 16 query
heads a KV head, in float32 and bfloat16, and two backward calls bit-equal
(the kernels use no atomics); they skip where no card is present. The JAX
side is imported by a fixture, so the card-only tests also run on a machine
with the port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_bwd.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA

torch.set_num_threads(2)

#: query heads a KV head on the card (16: MQA at H=16, four positions of 16
#: heads in a 64-row tile)
CUDA_GROUPS = [1, 2, 4, 8, 16]


def _qkv(b, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import layers as jax_layers
    return types.SimpleNamespace(jnp=jnp, layers=jax_layers)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (b, s, h, hkv, d, kv_chunk): G = H / Hkv of 1, 2 and 4, ragged lengths
# (37, 130) and a chunk that does not divide S, so the last chunk is short
GRAD_SHAPES = [
    (1, 32, 4, 4, 16, 16),
    (2, 64, 4, 2, 16, 16),
    (1, 37, 8, 2, 16, 16),
    (2, 130, 8, 4, 32, 64),
]
# test_layers.py's tolerance for the custom VJP against autodiff
GRAD_TOL = 1e-4


def _grad_inputs(b, s, h, hkv, d, seed=7):
    q, k, v = _qkv(b, s, h, hkv, d, seed=seed)
    dout = np.random.default_rng(seed + 1).standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("b,s,h,hkv,d,chunk", GRAD_SHAPES)
def test_plain_fwd_lse_matches_jax_flash_fwd_impl(ref, b, s, h, hkv, d, chunk):
    """``flash_attention_fwd_plain``'s (out, lse) against the JAX package's
    ``_flash_fwd_impl``: lse (B, H, S) is JAX's (B, Hkv, G, S) flattened."""
    jnp = ref.jnp
    q, k, v, _ = _grad_inputs(b, s, h, hkv, d)
    want_out, want_lse = ref.layers._flash_fwd_impl(*(jnp.asarray(a) for a in (q, k, v)), chunk)
    out, lse = FA.flash_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                            kv_chunk=chunk)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse).reshape(b, h, s),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,s,h,hkv,d,chunk", GRAD_SHAPES)
def test_plain_bwd_matches_jax_custom_vjp_and_torch_autograd(ref, b, s, h, hkv, d, chunk):
    """``flash_attention_bwd_plain`` against ``jax.vjp`` of
    ``flash_attention_jnp`` (its custom VJP, the real flash backward) and
    against torch autograd through ``flash_attention_plain`` (materialised
    scores), at test_layers.py's rtol/atol 1e-4."""
    import jax
    jnp = ref.jnp
    q, k, v, dout = _grad_inputs(b, s, h, hkv, d)
    _, vjp = jax.vjp(lambda *a: ref.layers.flash_attention_jnp(*a, chunk),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want_jax = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    FA.flash_attention_plain(tq, tk, tv).backward(torch.from_numpy(dout))
    out, lse = FA.flash_attention_fwd_plain(tq.detach(), tk.detach(), tv.detach(),
                                            kv_chunk=chunk)
    got = FA.flash_attention_bwd_plain(tq.detach(), tk.detach(), tv.detach(), out, lse,
                                       torch.from_numpy(dout), kv_chunk=chunk)
    for name, g, wj, wt in zip("qkv", got, want_jax, (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(wj), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name} vs jax")
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name} vs torch autograd")


def test_plain_bwd_keeps_the_reference_mixed_precision(ref):
    """In bfloat16 the plain backward follows ``_flash_bwd_rule``'s casts (p
    float32 for dv, ds in bfloat16 for dq and dk): it lands within one
    bfloat16 rounding of the JAX rule's gradients."""
    import jax
    jnp = ref.jnp
    b, s, h, hkv, d = 1, 40, 4, 2, 16
    q, k, v, dout = _grad_inputs(b, s, h, hkv, d, seed=11)
    jb = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, dout)]
    _, vjp = jax.vjp(lambda *a: ref.layers.flash_attention_jnp(*a, 16), *jb[:3])
    want = vjp(jb[3])
    tb = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, dout)]
    out, lse = FA.flash_attention_fwd_plain(*tb[:3], kv_chunk=16)
    got = FA.flash_attention_bwd_plain(*tb[:3], out, lse, tb[3], kv_chunk=16)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=2e-2, atol=2e-2,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("b,s,h,hkv,d,chunk", GRAD_SHAPES)
def test_flash_attention_function_gives_the_plain_gradients_on_cpu(b, s, h, hkv, d, chunk):
    """``flash_attention`` on CPU tensors that require grad goes through
    ``FlashAttention``: the plain forward with its lse, then the plain
    backward, on a strided incoming gradient too; it launches nothing."""
    q, k, v, dout = _grad_inputs(b, s, h, hkv, d)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    FA.flash_attention_plain(tq, tk, tv).backward(torch.from_numpy(dout))
    want = (tq.grad, tk.grad, tv.grad)
    before = (FA.launches, FA.bwd_launches)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = FA.flash_attention(tq, tk, tv)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    # a gradient that arrives through a transpose is not contiguous
    (out.transpose(1, 2) * torch.from_numpy(dout).transpose(1, 2)).sum().backward()
    assert (FA.launches, FA.bwd_launches) == before
    for name, g, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_flash_attention_second_order_gradient_raises():
    """The backward is a kernel launch with no graph of its own, so a
    gradient of the gradient raises instead of coming back as zero."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 9, 4, 2, 8))
    dq, = torch.autograd.grad(FA.flash_attention(q, k, v).sum(), q, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(dq.sum(), q)


def test_flash_attention_without_grad_keeps_the_serving_path():
    """Under no_grad (or inputs that need no grad) the wrapper returns the
    plain forward with no graph, as serving's inference_mode does."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(1, 9, 4, 2, 8))
    with torch.no_grad():
        out = FA.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert FA.flash_attention(q.detach(), k.detach(), v.detach()).grad_fn is None
    torch.testing.assert_close(out, FA.flash_attention_plain(q.detach(), k.detach(), v.detach()))


@pytest.mark.parametrize("b,s,h,hkv", [(1, 1, 16, 16), (2, 7, 16, 8), (1, 130, 16, 1),
                                       (4, 2048, 16, 8), (1, 3, 128, 1)])
def test_bwd_scratch_holds_every_row_statistic(b, s, h, hkv):
    """The scratch the wrapper gives the backward kernels: two float32
    values for each row, a (batch row, KV head)'s S x G rows padded to a
    128-row block, which also holds float32's B x H x S deltas."""
    n = FA._bwd_scratch_values(b, s, h, hkv)
    rows = -(-s * (h // hkv) // 128) * 128
    assert n == 2 * b * hkv * rows and n >= 2 * b * h * s and rows % 128 == 0


# the backward kernel against the plain backward on the card: max abs error
# within atol + rtol |want|, and the error's norm over the gradient's.
# float32 (CUDA cores) differs only in the order of float32 sums. bfloat16
# (wgmma) rounds ds to bfloat16 for dq and dk as the reference does, and
# P for dv where the reference keeps float32: an output rounding (2^-8 of
# it), ds values that round to the other neighbour, 2^-9 of each dv term
BWD_TOL = {"float32": (1e-4, 1e-4, 2e-5), "bfloat16": (2e-2, 2e-2, 1e-2)}
#: the forward's lse against the plain lse (float32 sums in another order;
#: the bfloat16 route's exp2 and tensor-core sums)
LSE_TOL = {"float32": 2e-5, "bfloat16": 1e-4}
#: a gradient whose RMS is below this is rounding, not signal
RMS_FLOOR = 1e-3
#: lengths around the 64-key and 64-row tiles and the 128-key and 128-row
#: blocks of the bfloat16 kernels
CUDA_BWD_LENGTHS = [1, 7, 63, 64, 65, 127, 128, 129, 130, 255, 256, 257]


def _dv_with_bf16_p(q, k, lse, dout):
    """dv as the bfloat16 kernel computes it: P = exp(s scale - lse) in
    float32, rounded to bfloat16, times dO, summed in float32."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    sc = torch.einsum("bqkgd,bckd->bkgqc", q.reshape(b, s, hkv, g, d).float(),
                      k.float()) / d ** 0.5
    pos = torch.arange(s, device=q.device)
    sc = torch.where(pos[None, :] <= pos[:, None], sc, FA.MASK)
    p = torch.exp(sc - lse.reshape(b, hkv, g, s)[..., None]).bfloat16().float()
    return torch.einsum("bkgqc,bqkgd->bckd", p, dout.reshape(b, s, hkv, g, d).float())


def _kernel_grads(b, s, h, hkv, d, dtype, device):
    """The inputs, the forward's lse and the gradients of one training
    forward and backward through the kernels, and the plain backward's."""
    tdt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(a).to(device, tdt)
                     for a in _grad_inputs(b, s, h, hkv, d))
    want_out, want_lse = FA.flash_attention_fwd_plain(q, k, v)
    before = (FA.launches, FA.bwd_launches)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    out = FA.flash_attention(tq, tk, tv)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (FA.launches, FA.bwd_launches) == (before[0] + 1, before[1] + 1)
    _, lse = FA._launch(q, k, v, with_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=LSE_TOL[dtype])
    want = FA.flash_attention_bwd_plain(q, k, v, out.detach(), lse, dout)
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert g.dtype == tdt and g.shape == w.shape
    return (q, k, lse, dout), (tq.grad, tk.grad, tv.grad), want


def _assert_norm_close(name, g, w, dtype):
    # the norm gate where the gradient is above rounding: at S=1 dq is 0
    # (one key: ds = p (dp - delta) = 0) and both sides hold rounding
    want_norm = torch.linalg.vector_norm(w.float()).item()
    if want_norm > RMS_FLOOR * w.numel() ** 0.5:
        rel = torch.linalg.vector_norm(g.float() - w.float()).item() / want_norm
        assert rel <= BWD_TOL[dtype][2], (name, rel)


def _assert_bwd_matches_plain(b, s, h, hkv, d, dtype, device):
    _, got, want = _kernel_grads(b, s, h, hkv, d, dtype, device)
    rtol, atol, _ = BWD_TOL[dtype]
    for name, g, w in zip("qkv", got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"d{name}: {m}")
        _assert_norm_close(name, g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("g", CUDA_GROUPS)
@pytest.mark.parametrize("s", CUDA_BWD_LENGTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain(cuda_device, g, s, dtype):
    _assert_bwd_matches_plain(1 if s == 257 else 2, s, 16, 16 // g, 128, dtype, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("hkv", [4, 2, 1])
@pytest.mark.parametrize("s", [7, 130])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain_past_16_heads_a_group(cuda_device, hkv, s, dtype):
    """G = 32, 64 and 128 query heads a KV head (H=128): a 64-row tile of
    the bfloat16 dk/dv kernel holds two positions, one, or half of one.
    bfloat16 dv sums P rounded to bfloat16 over G heads x positions, so its
    error grows with G: against the float32-P plain version a few of its
    small elements leave the max-abs tolerance past 32 heads (4 of 16,640
    at G=128, S=130) while its error norm stays near 2e-3. So in bfloat16
    dv is held element by element to the same sum with P rounded
    (``_dv_with_bf16_p``) and by its error norm to the plain version."""
    if dtype == "float32":
        _assert_bwd_matches_plain(1, s, 128, hkv, 128, dtype, cuda_device)
        return
    (q, k, lse, dout), got, want = _kernel_grads(1, s, 128, hkv, 128, dtype, cuda_device)
    rtol, atol, _ = BWD_TOL[dtype]
    elementwise = (want[0], want[1], _dv_with_bf16_p(q, k, lse, dout))
    for name, g, e, w in zip("qkv", got, elementwise, want):
        torch.testing.assert_close(g.float(), e.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"d{name}: {m}")
        _assert_norm_close(name, g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain_at_a_training_shape(cuda_device, dtype):
    """qwen3-0.6b's H=16, Hkv=8 at 2 x 1024: 16 key tiles a row of blocks."""
    _assert_bwd_matches_plain(2, 1024, 16, 8, 128, dtype, cuda_device)


@pytest.mark.cuda
def test_cuda_bwd_routes_report_their_design(cuda_device):
    """float32 on the CUDA cores (256 threads), bfloat16 on the tensor cores
    (wgmma + TMA, 3 warpgroups); each kernel fits an SM and spills nothing."""
    for dtype, design, threads in ((torch.float32, "CUDA-core FMA", 256),
                                   (torch.bfloat16, "wgmma + TMA", 384)):
        info = FA.bwd_route_info(dtype)
        for name in ("dkdv", "dq"):
            assert (info[name]["design"], info[name]["threads"]) == (design, threads)
            assert info[name]["blocks_per_sm"] >= 1
            assert info[name]["local_bytes"] == 0, (dtype, name, info[name])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_is_deterministic(cuda_device, dtype):
    """The kernels sum without atomics: two backward calls on the same
    inputs give bit-equal dq, dk and dv (training shape, 2 x 1024, and a
    ragged MQA shape)."""
    tdt = getattr(torch, dtype)
    for b, s, h, hkv in ((2, 1024, 16, 8), (1, 257, 16, 1)):
        q, k, v, dout = (torch.from_numpy(a).to(cuda_device, tdt)
                         for a in _grad_inputs(b, s, h, hkv, 128))
        out, lse = FA._launch(q, k, v, with_lse=True)
        first = FA._launch_bwd(q, k, v, out, lse, dout)
        second = FA._launch_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(x, y), (name, b, s, h, hkv, dtype)
