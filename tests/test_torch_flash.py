"""The port's causal GQA attention kernel module against the JAX package.

On the CPU the wrapper runs the plain PyTorch version. It is held against
the Pallas kernel in interpret mode at ``tests/test_kernels.py``'s four
shapes, at group sizes 3 and 7 (deepseek-coder-33b's), and against the
jnp oracle ``ref.flash_attention_ref`` and the kv-chunked
``layers.flash_attention_jnp`` at those shapes and at ragged sequence
lengths (37, 130), where the Pallas kernel asserts divisibility. Inputs are
standard normal, so the softmax stays spread, not one-hot. The wrapper's
group check (the forward and the backward any G up to 128) runs on the
CPU too.

The ``cuda``-marked tests hold the CUDA kernel itself against the plain
version, by max absolute error and by the error's norm, at d=128 for
lengths around its 64-key tiles, for 1, 2, 4 and 8 query heads a KV head,
and at qwen3-0.6b's 8 x 2048 prefill, in both routes (bfloat16 and float32
in 3xTF32, both wgmma on the tensor cores), and the float32 kernel on
inputs holding +-inf and NaN; the bfloat16 kernel also at d=64 over the
same lengths and groups and at granite-3-2b's 8 x 2048 prefill (H=32,
Hkv=8), and the widths the kernels are not compiled for refused with no
launch (float32 at d=64, with or without the gradient); both routes at G
= 3, 5, 6, 7 over the same lengths and at deepseek-coder-33b's 8 x 2048
prefill (H=56, Hkv=8), written into a NaN-fenced buffer (every element of
the output written, none around it), the float32 route's inf/NaN flag at
G=7 blind to the next group's heads in its idle rows, and a gradient at
G=3 launching each kernel once; they skip where no card is
present (``chip_smoke.py`` does the same at qwen3-0.6b's, granite-3-2b's
and deepseek-coder-33b's widths). The JAX side is imported by a fixture, so
that the card-only tests also run on a machine with the port's
dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops

torch.set_num_threads(2)

# (b, s, h, hkv, d, pallas block_q, pallas block_kv); block None: S is
# ragged for the Pallas kernel, which is then left out
SHAPES = [
    (2, 128, 8, 4, 32, 32, 32),
    (1, 64, 4, 1, 16, 16, 32),      # MQA
    (2, 256, 4, 2, 64, 64, 64),
    (1, 128, 8, 8, 64, 128, 128),   # MHA, single tile
    (2, 37, 4, 2, 16, None, None),  # ragged
    (1, 130, 16, 8, 32, None, None),
    (1, 128, 14, 2, 32, 32, 32),    # G=7, deepseek-coder-33b's group size
    (1, 64, 6, 2, 16, 16, 32),      # G=3
]
DTYPES = [("float32", 2e-5), ("bfloat16", 3e-2)]
# the card also holds the error's norm over the output's norm: float32 to
# 2e-5; two right bfloat16 results differ by about one rounding of the
# output (2^-8 of it), so 1e-2
REL_NORM_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
# shapes for the card at qwen3-0.6b's head width: ragged lengths and
# lengths around the kernel's 64-key tiles (63, 64, 65 cross the diagonal
# inside a tile, at its edge, one key past it), at G = H / Hkv of 1, 2
# (qwen3-0.6b's 16 / 8), 4 and 8 query heads a KV head
CUDA_LENGTHS = [1, 7, 63, 64, 65, 130, 257]
CUDA_GROUPS = [1, 2, 4, 8]
CUDA_SHAPES = [(1 if s in (1, 257) else 2, s, 16, 16 // g, 128)
               for g in CUDA_GROUPS for s in CUDA_LENGTHS]
# the same at d=64, granite-3-2b's head width (the bfloat16 kernel only)
CUDA_SHAPES_D64 = [(b, s, h, hkv, 64) for b, s, h, hkv, _ in CUDA_SHAPES]
# group sizes that are not powers of two, over 2 KV heads: the forward pads
# G to the next power of two (3 -> 4, 5, 6, 7 -> 8), so the first group's
# idle rows hold the second group's first heads and the second group's lie
# past H; lengths around the 16- and 32-position blocks and the 64-key tiles
CUDA_ODD_GROUPS = [3, 5, 6, 7]
CUDA_ODD_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 130, 257]
CUDA_SHAPES_ODD_G = [(2, s, 2 * g, 2, 128) for g in CUDA_ODD_GROUPS for s in CUDA_ODD_LENGTHS]


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
    from repro.kernels import ops as jax_kops, ref as jax_ref
    from repro.models import layers as jax_layers
    return types.SimpleNamespace(jnp=jnp, kops=jax_kops, ref=jax_ref,
                                 layers=jax_layers)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,s,h,hkv,d,bq,bk", SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_plain_flash_matches_pallas_oracle_and_jnp(ref, b, s, h, hkv, d, bq, bk,
                                                   dtype, tol):
    jnp = ref.jnp
    q, k, v = _qkv(b, s, h, hkv, d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    wants = {"oracle": ref.ref.flash_attention_ref(jq, jk, jv),
             "jnp": ref.layers.flash_attention_jnp(jq, jk, jv, 32)}
    if bq is not None and dtype == "float32":   # interpret mode is slow
        wants["pallas"] = ref.kops.flash_attention(jq, jk, jv, block_q=bq,
                                                   block_kv=bk, interpret=True)
    before = FA.launches
    got = kops.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)))
    assert FA.launches == before   # the CPU path launches nothing
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h, d)
    got = got.float().numpy()
    for name, want in wants.items():
        np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("s", [1, 5, 33])
def test_plain_flash_is_per_head_causal_softmax(s):
    """Query head h reads KV head h // G, each row sees keys 0..its own
    position: an independent loop over heads and rows with plain softmax."""
    b, h, hkv, d = 2, 6, 2, 8
    q, k, v = (torch.from_numpy(a).double() for a in _qkv(b, s, h, hkv, d, seed=3))
    want = torch.empty((b, s, h, d), dtype=torch.float64)
    for hh in range(h):
        kh, vh = k[:, :, hh // (h // hkv)], v[:, :, hh // (h // hkv)]
        for t in range(s):
            sc = torch.einsum("bd,bsd->bs", q[:, t, hh], kh[:, :t + 1]) / d ** 0.5
            want[:, t, hh] = torch.einsum("bs,bsd->bd", torch.softmax(sc, -1),
                                          vh[:, :t + 1])
    got = FA.flash_attention(*(x.float() for x in (q, k, v)))
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s,start", [(9, 0), (9, 4), (130, 97)])
def test_plain_flash_takes_a_slice_of_query_rows(s, start):
    """Rows ``start..s-1`` against all ``s`` keys equal those rows of the
    whole sequence's attention: how a long sequence is checked by slices."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, s, 4, 2, 16, seed=5))
    whole = FA.flash_attention_plain(q, k, v)
    part = FA.flash_attention_plain(q[:, start:], k, v, q_start=start)
    np.testing.assert_allclose(part.numpy(), whole[:, start:].numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("g", [1, 2, 3, 5, 6, 7, 8, 64, 96, 127, 128, 129])
def test_group_check_forward_takes_any_g_backward_a_divisor(g):
    """The kernels pad a G that is not a power of two to the next one, and
    take any G up to 128 both ways (the backward once took only a G dividing
    128; the name is kept); the backward's scratch holds every row."""
    if g > FA.KERNEL_ROWS:
        with pytest.raises(ValueError, match="up to 128"):
            FA._check_group(g)
    else:
        FA._check_group(g)
    assert FA._bwd_scratch_values(1, 3, g, 1) >= 2 * 3 * g


def _good():
    q, k, v = _qkv(1, 4, 4, 2, 8)
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)


@pytest.mark.parametrize("case", [
    "float64", "mixed_dtype", "rank", "kv_shape", "kv_differ", "gqa",
    "non_contiguous", "empty",
])
def test_wrapper_refuses_bad_inputs(case):
    q, k, v = _good()
    if case == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "rank":
        q = q[0]
    elif case == "kv_shape":
        k, v = k[:, :3], v[:, :3]
    elif case == "kv_differ":
        v = v[:, :, :1].contiguous()
    elif case == "gqa":
        k, v = (torch.zeros((1, 4, 3, 8)),) * 2
    elif case == "non_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "empty":
        q, k, v = q[:, :0], k[:, :0], v[:, :0]
    with pytest.raises((ValueError, TypeError)):
        FA.flash_attention(q, k, v)


def _assert_kernel_matches_plain(b, s, h, hkv, d, dtype, tol, device, fenced=False):
    """The kernel against the plain version; with ``fenced``, launched into
    the middle of a buffer filled with NaN that holds one position's rows
    more on each side: every element of the output is written, and nothing
    around it."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(device, tdt) for a in _qkv(b, s, h, hkv, d))
    before = FA.launches
    if fenced:
        buf = torch.full((b * s + 2, h, d), float("nan"), dtype=tdt, device=device)
        got = FA._launch(q, k, v, out=buf[1:-1].view(b, s, h, d))
    else:
        got = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert FA.launches == before + 1
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h, d)
    if fenced:
        assert buf[0].isnan().all() and buf[-1].isnan().all()
        assert not got.isnan().any()
    want = FA.flash_attention_plain(q, k, v).float()
    torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)
    rel = (torch.linalg.vector_norm(got.float() - want) / torch.linalg.vector_norm(want)).item()
    assert rel <= REL_NORM_TOL[dtype], rel


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d", CUDA_SHAPES)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_kernel_matches_plain(cuda_device, b, s, h, hkv, d, dtype, tol):
    _assert_kernel_matches_plain(b, s, h, hkv, d, dtype, tol, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_kernel_matches_plain_at_the_prefill_shape(cuda_device, dtype, tol):
    """qwen3-0.6b's prefill of 8 x 2048 (H=16, Hkv=8): 32 diagonal tiles a
    row of blocks, and the error's norm gate where randn outputs are small."""
    _assert_kernel_matches_plain(8, 2048, 16, 8, 128, dtype, tol, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d", CUDA_SHAPES_D64)
def test_cuda_bfloat16_kernel_matches_plain_at_d64(cuda_device, b, s, h, hkv, d):
    _assert_kernel_matches_plain(b, s, h, hkv, d, "bfloat16", 3e-2, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,d", CUDA_SHAPES_ODD_G)
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_kernel_matches_plain_at_odd_groups(cuda_device, b, s, h, hkv, d, dtype, tol):
    """A group size that is not a power of two, in both routes: the idle
    rows are never stored, into the output or around it."""
    _assert_kernel_matches_plain(b, s, h, hkv, d, dtype, tol, cuda_device, fenced=True)


@pytest.mark.cuda
def test_cuda_bfloat16_kernel_matches_plain_at_coder_prefill(cuda_device):
    """deepseek-coder-33b's prefill of 8 x 2048 (H=56, Hkv=8, d=128: G=7)."""
    _assert_kernel_matches_plain(8, 2048, 56, 8, 128, "bfloat16", 3e-2, cuda_device,
                                 fenced=True)


@pytest.mark.cuda
def test_cuda_bfloat16_kernel_matches_plain_at_granite_prefill(cuda_device):
    """granite-3-2b's prefill of 8 x 2048 (H=32, Hkv=8, d=64: G=4)."""
    _assert_kernel_matches_plain(8, 2048, 32, 8, 64, "bfloat16", 3e-2, cuda_device)


@pytest.mark.cuda
def test_cuda_d64_route_reports_its_design(cuda_device):
    """The bfloat16 kernel at d=64 is the d=128 design (wgmma + TMA, three
    warpgroups) on half the shared memory; float32 has no d=64 route."""
    d64, d128 = FA.route_info(torch.bfloat16, 64), FA.route_info(torch.bfloat16, 128)
    assert (d64["stage"], d64["design"], d64["threads"]) == (2, "wgmma + TMA", 384)
    assert d64["blocks_per_sm"] >= 1 and d64["local_bytes"] == 0
    assert d64["dynamic_smem"] < d128["dynamic_smem"]
    with pytest.raises(ValueError, match="compiled for head widths"):
        FA.route_info(torch.float32, 64)


@pytest.mark.cuda
def test_cuda_routes_report_their_design(cuda_device):
    """Both routes run on the tensor cores with three warpgroups (a TMA
    producer, for float32 also the splitter, and two consumer warpgroups):
    bfloat16 in wgmma + TMA (stage 2), float32 in 3xTF32 wgmma + TMA
    (stage 4); each fits at least one block on an SM and spills nothing."""
    bf16, f32 = FA.route_info(torch.bfloat16), FA.route_info(torch.float32)
    assert (bf16["stage"], bf16["design"], bf16["threads"]) == (2, "wgmma + TMA", 384)
    assert (f32["stage"], f32["design"], f32["threads"]) == (4, "3xTF32 wgmma + TMA", 384)
    for info in (bf16, f32):
        assert info["blocks_per_sm"] >= 1 and info["local_bytes"] == 0


@pytest.mark.cuda
def test_cuda_float32_kernel_follows_plain_on_inf_and_nan(cuda_device):
    """+-inf and NaN in q and k follow float32, not the 3xTF32 split: the
    kernel's NaN positions are the plain version's, and every other value
    agrees at the float32 gate. (v stays finite: the plain version sums
    0 x v over the masked keys, which a NaN in v turns into NaN for every
    row, where the kernel skips keys past a row's position.)"""
    b, s, h, hkv, d = 2, 130, 16, 8, 128
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(b, s, h, hkv, d, seed=5))
    q[0, 5, 3, 7] = float("inf")
    q[1, 40, 0, 0] = float("nan")
    q[0, 90, 1, 2] = -float("inf")
    k[0, 100, 2, 5] = float("nan")
    k[1, 64, 1, 1] = float("inf")
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert want.isnan().any() and not want.isnan().all()
    assert torch.equal(got.isnan(), want.isnan())
    finite = ~want.isnan()
    torch.testing.assert_close(got[finite], want[finite], rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_float32_kernel_follows_plain_on_inf_and_nan_at_g7(cuda_device):
    """G=7 over 2 KV heads: group 0's idle rows hold group 1's first head,
    which carries an inf here. Group 0 must not take it for its own (its
    rows stay finite and at the float32 gate), and a NaN in group 0's q
    still marks its own rows as the plain version does."""
    b, s, h, hkv, d = 1, 130, 14, 2, 128
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(b, s, h, hkv, d, seed=7))
    q[0, 20, 7, 3] = float("inf")      # group 1's first head
    q[0, 90, 2, 0] = float("nan")      # group 0
    got = FA.flash_attention(q, k, v)
    want = FA.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert want[:, :, 7].isnan().any() and not want[:, :, :2].isnan().any()
    assert torch.equal(got.isnan(), want.isnan())
    finite = ~want.isnan()
    torch.testing.assert_close(got[finite], want[finite], rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_kernel_refuses_an_uncompiled_head_width(cuda_device):
    """float32 at d=64: only the bfloat16 kernel is compiled there."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.float32)
               for a in _qkv(1, 8, 4, 2, 64))
    before = FA.launches
    with pytest.raises(ValueError, match="compiled for head widths"):
        FA.flash_attention(q, k, v)
    assert FA.launches == before


@pytest.mark.cuda
def test_cuda_bfloat16_kernel_refuses_an_uncompiled_head_width(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _qkv(1, 8, 4, 2, 32))
    before = FA.launches
    with pytest.raises(ValueError, match="compiled for head widths"):
        FA.flash_attention(q, k, v)
    assert FA.launches == before


@pytest.mark.cuda
def test_cuda_kernel_refuses_the_gradient_at_d64(cuda_device):
    """float32 has no kernel at d=64 in either direction, so a float32 call
    at d=64 that needs the gradient raises before the forward launches (a
    training step would otherwise fail only in its backward). The bfloat16
    backward is compiled at d=64 (granite-3-2b trains there): the same call
    in bfloat16 launches the forward, and its backward the backward."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.float32).requires_grad_()
               for a in _qkv(1, 8, 4, 2, 64))
    before, bwd_before = FA.launches, FA.bwd_launches
    with pytest.raises(ValueError, match="compiled for head widths"):
        FA.flash_attention(q, k, v)
    assert (FA.launches, FA.bwd_launches) == (before, bwd_before)
    q, k, v = (x.detach().bfloat16().requires_grad_() for x in (q, k, v))
    FA.flash_attention(q, k, v).float().sum().backward()
    torch.cuda.synchronize()
    assert (FA.launches, FA.bwd_launches) == (before + 1, bwd_before + 1)
    assert all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))


@pytest.mark.cuda
def test_cuda_backward_refuses_a_group_that_does_not_divide_its_rows(cuda_device):
    """G=3, a G that does not divide 128, which the backward once refused
    (the name is kept): the forward launches once; with the gradient each
    kernel launches once and the gradients match the plain backward's."""
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(1, 8, 12, 4, 128))
    before, bwd_before = FA.launches, FA.bwd_launches
    FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (FA.launches, FA.bwd_launches) == (before + 1, bwd_before)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = FA.flash_attention(q, k, v)
    dout = torch.ones_like(out)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (FA.launches, FA.bwd_launches) == (before + 2, bwd_before + 1)
    _, lse = FA.flash_attention_fwd_plain(q.detach(), k.detach(), v.detach())
    want = FA.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                        lse, dout)
    for name, g, w in zip("qkv", (q.grad, k.grad, v.grad), want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4, msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_group_past_its_rows(cuda_device):
    """G=129 raises before any launch, with or without the gradient."""
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _qkv(1, 8, 129, 1, 128))
    before = (FA.launches, FA.bwd_launches)
    with pytest.raises(ValueError, match="up to 128"):
        FA.flash_attention(q, k, v)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    with pytest.raises(ValueError, match="up to 128"):
        FA.flash_attention(q, k, v)
    assert (FA.launches, FA.bwd_launches) == before


@pytest.mark.cuda
def test_cuda_kernel_refuses_a_cpu_key(cuda_device):
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 4, 2, 128))
    with pytest.raises(ValueError, match="devices differ"):
        FA.flash_attention(q.to(cuda_device), k, v.to(cuda_device))
