"""The port's EmbeddingBag kernel module against the JAX package.

On the CPU the wrapper runs the plain PyTorch version. It is held against
the JAX package's oracle ``ref.embedding_bag_ref`` at
``tests/test_kernels.py``'s parameter grid, with its tolerances (float32
1e-5, bfloat16 3e-2), and an L=1 bag with no weights is held bit for bit
against ``jnp.take``, the lookup DLRM makes. The Pallas kernel itself is no
target: under the installed jax it raises ``AttributeError`` on ``pl.load``
(ROADMAP.md, faults item 1).

The ``cuda``-marked tests hold the CUDA kernel itself against the plain
version and skip where no card is present (``chip_smoke.py`` does the same
at dlrm-mlperf's shapes over its full table). The JAX side is imported by
a fixture, so that the card-only tests also run on a machine with the
port's dependencies alone:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_embedding_bag.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import ops as kops

torch.set_num_threads(2)

# tests/test_kernels.py::test_embedding_bag's (V, d, B, L) grid
SHAPES = [(100, 16, 8, 4), (1000, 32, 16, 10), (64, 8, 4, 1)]
DTYPES = [("float32", 1e-5), ("bfloat16", 3e-2)]
# the card: the grid, DLRM's L=1 bags at d=128, a wide row (d > 128 takes
# a second slice per lane), ragged bag counts (not a multiple of the 8
# bags of a block) and empty bags (L=0)
CUDA_SHAPES = SHAPES + [(5000, 128, 1000, 1), (300, 256, 13, 3), (50, 128, 1, 7),
                        (50, 128, 9, 0)]


def _inputs(v, d, b, l, weighted, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (b, l)).astype(np.float32) if weighted else None
    return table, ids, w


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    return types.SimpleNamespace(jnp=jnp, ref=jax_ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("v,d,b,l", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_plain_bag_matches_jax_oracle(ref, v, d, b, l, weighted, dtype, tol):
    jnp = ref.jnp
    table, ids, w = _inputs(v, d, b, l, weighted)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref.ref.embedding_bag_ref(jnp.asarray(table).astype(jdt), jnp.asarray(ids),
                                     None if w is None else jnp.asarray(w))
    before = EB.launches
    got = kops.embedding_bag(torch.from_numpy(table).to(tdt), torch.from_numpy(ids),
                             None if w is None else torch.from_numpy(w))
    assert EB.launches == before   # the CPU path launches nothing
    assert got.dtype == tdt and tuple(got.shape) == (b, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_single_row_bags_equal_jnp_take(ref, dtype):
    """DLRM's lookup as bags of one row, weight 1: bit for bit ``jnp.take``."""
    jnp = ref.jnp
    table, ids, _ = _inputs(777, 128, 64, 1, False, seed=2)
    jt = jnp.asarray(table).astype(jnp.dtype(dtype))
    want = np.asarray(jnp.take(jt, jnp.asarray(ids[:, 0]), axis=0).astype(jnp.float32))
    got = EB.embedding_bag(torch.from_numpy(table).to(getattr(torch, dtype)),
                           torch.from_numpy(ids))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_plain_bag_sums_in_order_in_float32():
    """An independent loop: each bag's weighted rows summed in float64."""
    table, ids, w = _inputs(50, 12, 6, 5, True, seed=3)
    want = np.zeros((6, 12))
    for b in range(6):
        for l in range(5):
            want[b] += float(w[b, l]) * table[ids[b, l]].astype(np.float64)
    got = EB.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(w))
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-5, atol=1e-6)


def _good():
    table, ids, w = _inputs(20, 8, 3, 2, True)
    return torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(w)


@pytest.mark.parametrize("case", [
    "float64", "int64_ids", "rank", "weights_shape", "int_weights",
    "non_contiguous", "empty", "id_past_the_table", "negative_id",
])
def test_wrapper_refuses_bad_inputs(case):
    table, ids, w = _good()
    if case == "float64":
        table = table.double()
    elif case == "int64_ids":
        ids = ids.long()
    elif case == "rank":
        ids = ids[0]
    elif case == "weights_shape":
        w = w[:, :1]
    elif case == "int_weights":
        w = w.int()
    elif case == "non_contiguous":
        table = table.t().contiguous().t()
    elif case == "empty":
        ids, w = ids[:0], w[:0]
    elif case == "id_past_the_table":
        ids[1, 1] = table.shape[0]
    elif case == "negative_id":
        ids[0, 0] = -1
    with pytest.raises((ValueError, TypeError)):
        EB.embedding_bag(table, ids, w)


@pytest.mark.cuda
@pytest.mark.parametrize("v,d,b,l", CUDA_SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype,tol", DTYPES)
def test_cuda_kernel_matches_plain(cuda_device, v, d, b, l, weighted, dtype, tol):
    tdt = getattr(torch, dtype)
    table, ids, w = (None if a is None else torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(v, d, b, l, weighted))
    table = table.to(tdt)
    before = EB.launches
    got = EB.embedding_bag(table, ids, w)
    torch.cuda.synchronize()
    assert EB.launches == before + 1
    want = EB.embedding_bag_plain(table, ids, w)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    if l == 1 and not weighted:
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_kernel_addresses_rows_past_2_31_elements(cuda_device):
    """Rows whose first element lies past 2^31 elements (float32, d=128:
    row 16,777,216 on): a 32-bit offset would read the wrong rows."""
    v, d = (1 << 24) + 4096, 128
    table = torch.empty((v, d), device=cuda_device)
    table[-8192:] = torch.randn((8192, d), device=cuda_device)
    ids = torch.randint(v - 8192, v, (4096, 2), device=cuda_device, dtype=torch.int32)
    got = EB.embedding_bag(table, ids)
    want = EB.embedding_bag_plain(table, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_kernel_refuses_an_uncompiled_width(cuda_device):
    table, ids, _ = (None if a is None else torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(30, 10, 4, 2, False))
    before = EB.launches
    with pytest.raises(ValueError, match="multiple of 4"):
        EB.embedding_bag(table, ids)
    assert EB.launches == before


@pytest.mark.cuda
def test_cuda_kernel_refuses_cpu_ids(cuda_device):
    table, ids, _ = _good()
    with pytest.raises(ValueError, match="devices differ"):
        EB.embedding_bag(table.to(cuda_device), ids)
