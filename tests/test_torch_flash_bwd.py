"""The gradient of the port's causal GQA attention against the JAX package.

On the CPU: ``flash_attention_fwd_plain``'s log-sum-exp against the JAX
package's ``_flash_fwd_impl``; ``flash_attention_bwd_plain`` against
``jax.vjp`` of ``flash_attention_jnp`` (its custom VJP, the real flash
backward) and against torch autograd through ``flash_attention_plain``, for
1, 2, 4, 3 and 7 query heads a KV head and ragged lengths, at test_layers.py's
rtol/atol 1e-4; in bfloat16, within a rounding of the JAX rule; and
``FlashAttention`` (what ``flash_attention`` runs where grad is needed)
giving those gradients on the CPU.

The ``cuda``-marked tests hold the backward kernel of
``csrc/flash_attention_bwd.cu`` against the plain backward, and the forward
kernel's lse against the plain lse, at d=128 for lengths around the 64-key
tiles and the bfloat16 kernels' 128-key and 128-row blocks, 1 to 16 query
heads a KV head, in float32 and bfloat16, and two backward calls bit-equal
(the kernels use no atomics; float32 also at 4 x 2048); in bfloat16 at
d=64 (granite-3-2b's H=32 over 32 / G KV heads, G 1 to 8, the same lengths,
and granite's 4 x 2048), where a float32 call raises before any launch;
both routes at G = 3, 5, 6, 7 (padded to the next power of two) over the
same lengths, deepseek-coder-33b's H=56, Hkv=8 at 4 x 2048 in bfloat16,
inf and NaN in the next group's first head leaving a group's gradients
equal to the plain ones, and two calls at G=7 bit-equal; they skip where
no card is present. The JAX
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


# (b, s, h, hkv, d, kv_chunk): G = H / Hkv of 1, 2, 4, 7 (deepseek-coder-33b's)
# and 3, ragged lengths (37, 130) and a chunk that does not divide S, so the
# last chunk is short
GRAD_SHAPES = [
    (1, 32, 4, 4, 16, 16),
    (2, 64, 4, 2, 16, 16),
    (1, 37, 8, 2, 16, 16),
    (2, 130, 8, 4, 32, 64),
    (1, 37, 14, 2, 16, 16),
    (2, 130, 12, 4, 32, 64),
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


@pytest.mark.parametrize("b,s,h,hkv,gp", [(1, 1, 16, 16, 1), (2, 7, 16, 8, 2),
                                          (1, 130, 16, 1, 16), (4, 2048, 16, 8, 2),
                                          (1, 3, 128, 1, 128), (4, 2048, 56, 8, 8),
                                          (2, 17, 14, 2, 8), (1, 1, 7, 1, 8),
                                          (1, 5, 96, 1, 128), (1, 3, 65, 1, 128)])
def test_bwd_scratch_holds_every_row_statistic(b, s, h, hkv, gp):
    """The scratch the wrapper gives the backward kernels: two float32
    values for each row, a (batch row, KV head)'s S x Gp rows (G padded to
    the power of two at or above it, the kernels' rows: G=7 takes 8) padded
    to a 128-row block, as the C side's ``scratch_values`` asks; it also
    holds float32's B x H x S deltas."""
    n = FA._bwd_scratch_values(b, s, h, hkv)
    rows = -(-s * gp // 128) * 128
    assert n == 2 * b * hkv * rows and n >= 2 * b * h * s and rows % 128 == 0


# the backward kernel against the plain backward on the card: max abs error
# within atol + rtol |want|, and the error's norm over the gradient's.
# float32 (3xTF32) differs in the order of float32 sums and by the dropped
# lo x lo product (2^-22 of each term); the kernels end each tensor-core
# accumulator chain after 16 tiles, since its truncation grows with the
# chain (unbounded, the 32,896 rows a key sums at G=128 leave the norm
# gate). bfloat16
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
#: query heads a KV head at d=64: granite-3-2b's H=32 over 32 / G KV heads
D64_GROUPS = [1, 2, 4, 8]


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
    """float32 in 3xTF32 mma.sync + TMA (8 warps), bfloat16 in wgmma + TMA
    (3 warpgroups), both on the tensor cores; each kernel fits an SM and
    spills nothing."""
    for dtype, design, threads in ((torch.float32, "3xTF32 mma.sync + TMA", 256),
                                   (torch.bfloat16, "wgmma + TMA", 384)):
        info = FA.bwd_route_info(dtype)
        for name in ("dkdv", "dq"):
            assert (info[name]["design"], info[name]["threads"]) == (design, threads)
            assert info[name]["blocks_per_sm"] >= 1
            assert info[name]["local_bytes"] == 0, (dtype, name, info[name])


def test_bwd_route_info_refuses_a_width_with_no_kernel():
    """The backward is compiled at d=64 and 128 in bfloat16 and at 128 in
    float32; any other (dtype, width) raises before the library loads."""
    assert FA.KERNEL_HEAD_DIMS[("backward", torch.bfloat16)] == (64, 128)
    assert FA.KERNEL_HEAD_DIMS[("backward", torch.float32)] == (128,)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32), (torch.bfloat16, 256)):
        with pytest.raises(ValueError, match="compiled for head widths"):
            FA.bwd_route_info(dtype, d)


@pytest.mark.cuda
@pytest.mark.parametrize("g", D64_GROUPS)
@pytest.mark.parametrize("s", CUDA_BWD_LENGTHS)
def test_cuda_bf16_bwd_kernel_matches_plain_at_d64(cuda_device, g, s):
    _assert_bwd_matches_plain(1 if s == 257 else 2, s, 32, 32 // g, 64, "bfloat16",
                              cuda_device)


@pytest.mark.cuda
def test_cuda_bf16_bwd_kernel_matches_plain_at_granites_training_shape(cuda_device):
    """granite-3-2b's H=32, Hkv=8, d=64 at 4 x 2048: 32 key tiles a row."""
    _assert_bwd_matches_plain(4, 2048, 32, 8, 64, "bfloat16", cuda_device)


@pytest.mark.cuda
def test_cuda_bf16_bwd_route_at_d64_reports_its_design(cuda_device):
    info = FA.bwd_route_info(torch.bfloat16, 64)
    for name in ("dkdv", "dq"):
        assert (info[name]["design"], info[name]["threads"]) == ("wgmma + TMA", 384)
        assert info[name]["blocks_per_sm"] >= 1 and info[name]["local_bytes"] == 0


@pytest.mark.cuda
def test_cuda_float32_at_d64_raises_before_any_launch(cuda_device):
    """float32 has no kernel at d=64 either way: the forward with or
    without grad and the backward raise ``ValueError`` and launch
    nothing."""
    q, k, v, dout = (torch.from_numpy(a).to(cuda_device)
                     for a in _grad_inputs(1, 64, 8, 2, 64))
    before = (FA.launches, FA.bwd_launches)
    with pytest.raises(ValueError, match="compiled for head widths"):
        FA.flash_attention(q, k, v)
    tq, tk, tv = (x.clone().requires_grad_() for x in (q, k, v))
    with pytest.raises(ValueError, match="compiled for head widths"):
        FA.flash_attention(tq, tk, tv)
    lse = torch.zeros((1, 8, 64), dtype=torch.float32, device=cuda_device)
    with pytest.raises(ValueError, match="compiled for head widths"):
        FA._launch_bwd(q, k, v, q.clone(), lse, dout)
    assert (FA.launches, FA.bwd_launches) == before


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


@pytest.mark.cuda
def test_cuda_float32_bwd_is_deterministic_at_the_training_length(cuda_device):
    """Two float32 backward calls at 4 x 2048 (G = 2, qwen3-0.6b's H=16,
    Hkv=8) give bit-equal dq, dk and dv: 128 tiles of 32 rows a key block,
    so each key's sums cross the 16-tile chain ends 8 times."""
    q, k, v, dout = (torch.from_numpy(a).to(cuda_device)
                     for a in _grad_inputs(4, 2048, 16, 8, 128))
    out, lse = FA._launch(q, k, v, with_lse=True)
    first = FA._launch_bwd(q, k, v, out, lse, dout)
    second = FA._launch_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    for name, x, y in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(x, y), name


#: group sizes that are not powers of two (deepseek-coder-33b's 7 among
#: them), over 2 KV heads so that group 0 has a next group
ODD_GROUPS = [3, 5, 6, 7]


@pytest.mark.cuda
@pytest.mark.parametrize("g", ODD_GROUPS)
@pytest.mark.parametrize("s", CUDA_BWD_LENGTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain_at_odd_groups(cuda_device, g, s, dtype):
    """G padded to the next power of two (7 and 5, 6 to 8, 3 to 4): each
    position's idle rows load zeros, add nothing to dk and dv and store no
    dq."""
    _assert_bwd_matches_plain(1 if s == 257 else 2, s, 2 * g, 2, 128, dtype, cuda_device)


@pytest.mark.cuda
def test_cuda_bf16_bwd_kernel_matches_plain_at_coders_training_shape(cuda_device):
    """deepseek-coder-33b's H=56, Hkv=8 (G=7), d=128 at 4 x 2048."""
    _assert_bwd_matches_plain(4, 2048, 56, 8, 128, "bfloat16", cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_idle_rows_never_read_the_next_groups_head(cuda_device, dtype):
    """G=7 over 2 KV heads: inf and NaN in q and dout of head 7, group 1's
    first head, which a box of 8 heads from group 0's first would hold.
    KV head 0's dk and dv and heads 0..6's dq stay finite and equal to the
    plain backward's."""
    tdt = getattr(torch, dtype)
    q, k, v, dout = (torch.from_numpy(a).to(cuda_device, tdt)
                     for a in _grad_inputs(2, 130, 14, 2, 128))
    q[:, 5::9, 7, :4] = float("inf")
    q[:, 3::11, 7, 9] = float("nan")
    dout[:, 2::7, 7, :] = float("nan")
    dout[:, 4::13, 7, 3] = float("-inf")
    out, lse = FA._launch(q, k, v, with_lse=True)
    got = FA._launch_bwd(q, k, v, out, lse, dout)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    rtol, atol, _ = BWD_TOL[dtype]
    for name, g, w in (("dq", got[0][:, :, :7], want[0][:, :, :7]),
                       ("dk", got[1][:, :, 0], want[1][:, :, 0]),
                       ("dv", got[2][:, :, 0], want[2][:, :, 0])):
        assert bool(torch.isfinite(w).all()), name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name}: {m}")
    assert not bool(torch.isfinite(got[1][:, :, 1]).all())   # group 1's own NaN


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_is_deterministic_at_g7(cuda_device, dtype):
    """Two backward calls at G=7 (coder's H=56, Hkv=8, 1 x 1024, and a
    ragged 2 x 257 at H=14, Hkv=2) give bit-equal dq, dk and dv."""
    tdt = getattr(torch, dtype)
    for b, s, h, hkv in ((1, 1024, 56, 8), (2, 257, 14, 2)):
        q, k, v, dout = (torch.from_numpy(a).to(cuda_device, tdt)
                         for a in _grad_inputs(b, s, h, hkv, 128))
        out, lse = FA._launch(q, k, v, with_lse=True)
        first = FA._launch_bwd(q, k, v, out, lse, dout)
        second = FA._launch_bwd(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        for name, x, y in zip(("dq", "dk", "dv"), first, second):
            assert torch.equal(x, y), (name, b, s, h, hkv, dtype)
