"""The EmbeddingBag gradient: ``embedding_bag_bwd_plain``, ``EmbeddingBag``
and the CUDA backward kernel, against the JAX package.

The JAX twin of the table gradient is the VJP of ``ref.embedding_bag_ref``
(``jnp.take``, then the weighted sum): ``jax.vjp`` of it with respect to
the table. In float32 the port agrees with it to rtol 1e-5 / atol 1e-4:
float32 sums in another order, over up to ~1,400 positions of N(0, 1)
values a row, differ by up to ~n 2^-24 sum|x|, ~1e-5 on rows that cancel
to near 0. Ids
follow that VJP: ``[-V, 0)`` wraps to ``id + V``, an id outside ``[-V, V)``
adds nothing.

In bfloat16 the port sums in float32 and rounds once. JAX's VJP sums a
bfloat16 table's gradient in bfloat16 (reference fault 8, ROADMAP.md §3:
3000 ones on one row give 256), so the bfloat16 target is JAX's float32
gradient of the same values rounded once: bit for bit where every float32
sum is exact (small integers), within one bfloat16 unit in the last place
otherwise.

A numpy model of the CUDA kernel's three passes (tiles of ``BWD_CHUNK``
sorted positions, the zero pass, the rows cut across tiles) is held bit for
bit against the plain version, so the order the plain version follows is
the kernel's. The ``cuda``-marked tests hold the kernel itself bit for bit
against the plain version, two calls bit-equal, and skip where no card is
present. The JAX side is imported by a fixture: the card's machine has no
JAX.

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_embedding_bag_bwd.py
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as EB

torch.set_num_threads(2)

#: (V, d, B, L): the forward tests' grid, a wide row, and DLRM-like bags of
#: one row over a small table (every row named many times, runs across
#: many tiles of 64 sorted positions)
SHAPES = [(100, 16, 8, 4), (1000, 32, 16, 10), (64, 8, 4, 1), (300, 256, 13, 3),
          (7, 128, 2000, 1), (40, 12, 300, 5)]
F32_TOL = dict(rtol=1e-5, atol=1e-4)
#: one bfloat16 unit in the last place, relative
BF16_ULP = 2.0 ** -8


def _inputs(v, d, b, l, weighted, seed=0, lo=None, hi=None):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((b, d)).astype(np.float32)
    ids = rng.integers(0 if lo is None else lo, v if hi is None else hi, (b, l)).astype(np.int32)
    w = rng.uniform(0.0, 1.0, (b, l)).astype(np.float32) if weighted else None
    return g, ids, w


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side of the comparison."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref
    from repro.models import recsys as jax_rec

    def grad(v, d, ids, w, g, dtype="float32"):
        """d/d table of sum(g * embedding_bag_ref(table, ids, w)), as numpy
        float32, from ``jax.vjp`` with respect to a (v, d) table of ``dtype``."""
        table = jnp.zeros((v, d), jnp.dtype(dtype))
        f = lambda t: jax_ref.embedding_bag_ref(   # noqa: E731
            t, jnp.asarray(ids), None if w is None else jnp.asarray(w))
        _, vjp = jax.vjp(f, table)
        (gt,) = vjp(jnp.asarray(g).astype(jnp.dtype(dtype)))
        return np.array(gt.astype(jnp.float32))

    return types.SimpleNamespace(jax=jax, jnp=jnp, rec=jax_rec, grad=grad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _t(*arrays, device="cpu"):
    return tuple(None if a is None else torch.from_numpy(a).to(device) for a in arrays)


# ------------------------------------------------------- against jax.vjp --

@pytest.mark.parametrize("v,d,b,l", SHAPES)
@pytest.mark.parametrize("weighted", [True, False])
def test_plain_bwd_matches_jax_vjp(ref, v, d, b, l, weighted):
    g, ids, w = _inputs(v, d, b, l, weighted)
    want = ref.grad(v, d, ids, w, g)
    before = EB.bwd_launches
    got = EB.embedding_bag_bwd(*_t(g, ids, w), v)
    assert EB.bwd_launches == before   # the CPU path launches nothing
    assert got.dtype == torch.float32 and tuple(got.shape) == (v, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    named = np.zeros(v, bool)
    named[ids.ravel()] = True
    assert not got.numpy()[~named].any()   # rows no id names are 0


@pytest.mark.parametrize("weighted", [True, False])
def test_heavy_repeats_match_jax_vjp(ref, weighted):
    """A 3-row field at B*L = 4,096: each row named ~1,365 times, its run
    cut across ~21 tiles of sorted positions."""
    g, ids, w = _inputs(3, 16, 1024, 4, weighted, seed=5)
    got = EB.embedding_bag_bwd(*_t(g, ids, w), 3)
    np.testing.assert_allclose(got.numpy(), ref.grad(3, 16, ids, w, g), **F32_TOL)


@pytest.mark.parametrize("which", ["minus_1", "minus_v", "v", "minus_v_minus_1", "far"])
@pytest.mark.parametrize("weighted", [True, False])
def test_ids_outside_the_table_follow_jax_vjp(ref, which, weighted):
    """[-V, 0) wraps to id + V; an id outside [-V, V) adds nothing."""
    v = 40
    bad = {"minus_1": -1, "minus_v": -v, "v": v, "minus_v_minus_1": -v - 1,
           "far": 2 ** 31 - 1}[which]
    g, ids, w = _inputs(v, 8, 30, 3, weighted, seed=4)
    ids[1, 2] = ids[4, 0] = ids[29, 1] = bad
    got = EB.embedding_bag_bwd(*_t(g, ids, w), v).numpy()
    want = ref.grad(v, 8, ids, w, g)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # the same as the gradient with the outside ids' positions left out
    keep = ids.copy()
    if which in ("minus_1", "minus_v"):
        keep[ids < 0] += v
        np.testing.assert_allclose(got, ref.grad(v, 8, keep, w, g), **F32_TOL)


def test_autograd_through_the_function_matches_jax_vjp(ref):
    """``embedding_bag`` on a table that requires grad is an ``EmbeddingBag``
    node; its CPU backward is the plain backward."""
    g, ids, w = _inputs(50, 12, 20, 3, True, seed=6)
    table = torch.zeros((50, 12), requires_grad=True)
    out = EB.embedding_bag(table, *_t(ids, w))
    assert type(out.grad_fn).__name__ == "EmbeddingBagBackward"
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(table.grad.numpy(), ref.grad(50, 12, ids, w, g), **F32_TOL)
    # the check route: both plain versions, the same gradient bit for bit
    plain = torch.zeros((50, 12), requires_grad=True)
    EB.embedding_bag_plain_route(plain, *_t(ids, w)).backward(torch.from_numpy(g))
    assert torch.equal(plain.grad, table.grad)


# -------------------------------------------------------------- bfloat16 --

@pytest.mark.parametrize("weighted", [True, False])
def test_bfloat16_is_the_float32_gradient_rounded_once(ref, weighted):
    """Small integers (weights multiples of 1/8): every float32 sum is exact
    in any order, so the float32 gradient rounded once to bfloat16 is one
    value, and the port gives it bit for bit; sums past 256 lose bits in
    bfloat16 and not here."""
    rng = np.random.default_rng(7)
    v, d, b, l = 5, 8, 1500, 2
    g = rng.integers(0, 5, (b, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, l)).astype(np.int32)
    w = (rng.integers(0, 17, (b, l)) / 8).astype(np.float32) if weighted else None
    want = torch.from_numpy(ref.grad(v, d, ids, w, g)).to(torch.bfloat16)
    assert float(want.float().abs().max()) > 256   # beyond bfloat16's exact integers
    got = EB.embedding_bag_bwd(torch.from_numpy(g).to(torch.bfloat16), *_t(ids, w), v)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("weighted", [True, False])
def test_bfloat16_random_within_one_unit_of_float32_rounded(ref, weighted):
    g, ids, w = _inputs(7, 128, 2000, 1, weighted, seed=8)
    g = torch.from_numpy(g).to(torch.bfloat16)
    want = ref.grad(7, 128, ids, w, g.float().numpy())   # float32 sums of the bf16 values
    got = EB.embedding_bag_bwd(g, *_t(ids, w), 7).float().numpy()
    np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-6)


def test_reference_sums_a_bfloat16_gradient_in_bfloat16(ref):
    """Reference fault 8: the VJP of DLRM's lookup (``jnp.take``) on a
    bfloat16 table adds 3000 ones on one row in bfloat16 and stops at 256
    (256 + 1 rounds back to 256); the port sums in float32 and rounds once:
    3000 -> 3008, the nearest bfloat16."""
    jnp = ref.jnp
    ids = np.zeros((3000, 1), np.int32)
    table = jnp.zeros((4, 8), jnp.bfloat16)
    _, vjp = ref.jax.vjp(lambda t: ref.rec.embedding_lookup(
        t, jnp.asarray(ids), jnp.zeros((1,), jnp.int32)), table)
    (jax_grad,) = vjp(jnp.ones((3000, 1, 8), jnp.bfloat16))
    assert float(jax_grad[0, 0].astype(jnp.float32)) == 256.0
    got = EB.embedding_bag_bwd(torch.ones((3000, 8), dtype=torch.bfloat16),
                               torch.from_numpy(ids), None, 4)
    assert got[0].float().tolist() == [3008.0] * 8
    assert not got[1:].float().any()


# ----------------------------------------------------- the kernel's order --

def _kernel_model(g, ids, w, v, chunk):
    """A numpy model of csrc/embedding_bag_bwd.cu's three kernels, float32
    step by step: tiles of ``chunk`` sorted positions (whole segments
    written, cut ones into two scratch slots a tile), the zero pass over
    unmarked rows, and the rows cut across tiles added from their slots in
    tile order by the tile where they start. Unwritten rows stay NaN."""
    b, bag_len = ids.shape
    d = g.shape[1]
    keys, perm = (x.numpy() for x in EB._sorted_positions(torch.from_numpy(ids), v))
    n_pos = keys.size
    n_tiles = -(-n_pos // chunk)
    grad = np.full((v, d), np.nan, np.float32)
    partial = np.full((2 * n_tiles, d), np.nan, np.float32)
    named = np.zeros(v, bool)

    def x(p):
        row = g[p // bag_len]
        return row if w is None else np.float32(w.ravel()[p]) * row

    def put(key, acc, cut, slot):
        if key >= v:
            return
        named[key] = True
        if cut:
            partial[slot] = acc
        else:
            grad[key] = acc

    for t in range(n_tiles):
        lo = t * chunk
        n = min(chunk, n_pos - lo)
        first, last = keys[lo], keys[lo + n - 1]
        cut_start = t > 0 and keys[lo - 1] == first
        cut_end = lo + n < n_pos and keys[lo + n] == last
        acc, cur, first_seg = np.zeros(d, np.float32), first, True
        for j in range(n):
            k = keys[lo + j]
            if k != cur:
                put(cur, acc, first_seg and cut_start, 2 * t)
                acc, cur, first_seg = np.zeros(d, np.float32), k, False
            if k < v:
                acc = acc + x(perm[lo + j])
        put(cur, acc, (first_seg and cut_start) or cut_end,
            2 * t if first_seg else 2 * t + 1)
    grad[~named] = 0.0
    for t in range(n_tiles - 1):
        lo, hi = t * chunk, (t + 1) * chunk
        row = keys[hi - 1]
        if row >= v or keys[hi] != row:
            continue
        first = keys[lo]
        if first == row and t > 0 and keys[lo - 1] == row:
            continue
        end = t + 1
        while end + 1 < n_tiles and keys[(end + 1) * chunk] == row:
            end += 1
        acc = partial[2 * t if first == row else 2 * t + 1].copy()
        for u in range(t + 1, end + 1):
            acc = acc + partial[2 * u]
        grad[row] = acc
    return grad


def _run_lengths_ids(seed):
    """Rows named 64, 128, 1, 63, 65, 300, 2 and 191 times (runs that fill
    tiles exactly, start on a tile's edge, or cross several), shuffled, plus
    a wrapped id and ids outside the table."""
    counts = [64, 128, 1, 63, 65, 300, 2, 191]
    ids = np.concatenate([np.full(c, r, np.int32) for r, c in enumerate(counts)])
    ids = np.concatenate([ids, np.array([-1, -20, 20, 1000], np.int32)])
    rng = np.random.default_rng(seed)
    return rng.permutation(ids)[:, None], len(counts) + 12


@pytest.mark.parametrize("case", ["run_lengths", "skewed", "uniform"])
@pytest.mark.parametrize("weighted", [True, False])
def test_kernel_model_is_bit_equal_to_the_plain_order(case, weighted):
    rng = np.random.default_rng(9)
    if case == "run_lengths":
        ids, v = _run_lengths_ids(9)
    elif case == "skewed":   # a Zipf-like field: a few rows take most positions
        v = 30
        ids = np.minimum(rng.zipf(1.3, (400, 3)) - 1, v + 5).astype(np.int32)
    else:
        v = 500
        ids = rng.integers(-v, v, (300, 2)).astype(np.int32)
    d = 8
    g = rng.standard_normal((ids.shape[0], d)).astype(np.float32)
    w = rng.uniform(0, 1, ids.shape).astype(np.float32) if weighted else None
    model = _kernel_model(g, ids, w, v, EB.BWD_CHUNK)
    assert not np.isnan(model).any()   # every row written
    plain = EB.embedding_bag_bwd_plain(*_t(g, ids, w), v).numpy()
    assert np.array_equal(model.view(np.uint32), plain.view(np.uint32))


def test_plain_order_is_segments_then_rows():
    """An independent loop over the stated order: a row's positions (in
    order of b * L + l) cut where the sorted position crosses a multiple of
    BWD_CHUNK, each piece summed from 0, then 0 plus the pieces."""
    ids, v = _run_lengths_ids(10)
    rng = np.random.default_rng(10)
    g = rng.standard_normal((ids.shape[0], 4)).astype(np.float32)
    w = rng.uniform(0, 1, ids.shape).astype(np.float32)
    flat = ids.ravel().astype(np.int64)
    flat = np.where(flat < 0, flat + v, flat)
    order = [p for p in np.argsort(np.where((flat >= 0) & (flat < v), flat, v),
                                   kind="stable") if 0 <= flat[p] < v]
    want = np.zeros((v, 4), np.float32)
    pieces = {}
    for i, p in enumerate(order):
        pieces.setdefault((flat[p], i // EB.BWD_CHUNK), []).append(p)
    for (row, _), ps in pieces.items():   # dict order: sorted order
        s = np.zeros(4, np.float32)
        for p in ps:
            s = s + np.float32(w.ravel()[p]) * g[p]
        want[row] = want[row] + s
    got = EB.embedding_bag_bwd_plain(*_t(g, ids, w), v).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------------- refusals --

@pytest.mark.parametrize("case", ["float64", "int64_ids", "rank", "rows", "weights_shape",
                                  "n_rows", "non_contiguous"])
def test_backward_refuses_bad_inputs(case):
    g, ids, w = _t(*_inputs(20, 8, 6, 2, True))
    v = 20
    if case == "float64":
        g = g.double()
    elif case == "int64_ids":
        ids = ids.long()
    elif case == "rank":
        ids = ids[0]
    elif case == "rows":
        g = g[:5]
    elif case == "weights_shape":
        w = w[:, :1]
    elif case == "n_rows":
        v = 0
    elif case == "non_contiguous":
        g = g.t().contiguous().t()
    with pytest.raises((ValueError, TypeError)):
        EB.embedding_bag_bwd(g, ids, w, v)


def test_weights_that_require_grad_raise():
    _, ids, w = _t(*_inputs(20, 8, 6, 2, True))
    table = torch.zeros((20, 8), requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EB.embedding_bag(table, ids, w.requires_grad_(True))
    with torch.no_grad():   # no gradient asked: the forward runs
        assert tuple(EB.embedding_bag(table, ids, w).shape) == (6, 8)


# ---------------------------------------------------------------- the card --

@pytest.mark.cuda
@pytest.mark.parametrize("v,d,b,l", SHAPES + [(5000, 128, 1000, 1), (50, 128, 9, 0)])
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_kernel_is_bit_equal_to_plain(cuda_device, v, d, b, l, weighted,
                                                     dtype):
    g, ids, w = _t(*_inputs(v, d, b, l, weighted), device=cuda_device)
    g = g.to(getattr(torch, dtype))
    before = EB.bwd_launches
    got = EB.embedding_bag_bwd(g, ids, w, v)
    again = EB.embedding_bag_bwd(g, ids, w, v)
    torch.cuda.synchronize()
    assert EB.bwd_launches == before + 2
    want = EB.embedding_bag_bwd_plain(g, ids, w, v)
    assert got.dtype == g.dtype and tuple(got.shape) == (v, d)
    assert torch.equal(got, want)     # the same float32 sums in the same order
    assert torch.equal(got, again)    # no atomics: two calls bit-equal


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_heavy_repeats_and_outside_ids(cuda_device, weighted, dtype):
    """A 3-row field at B*L = 65,536 (runs across ~340 tiles), then ids at
    -1, -V, V and -V-1."""
    g, ids, w = _t(*_inputs(3, 128, 65536, 1, weighted, seed=11), device=cuda_device)
    g = g.to(getattr(torch, dtype))
    assert torch.equal(EB.embedding_bag_bwd(g, ids, w, 3),
                       EB.embedding_bag_bwd_plain(g, ids, w, 3))
    v = 40
    for bad in (-1, -v, v, -v - 1):
        g, ids, w = _t(*_inputs(v, 8, 30, 3, weighted, seed=4), device=cuda_device)
        ids[1, 2] = ids[4, 0] = bad
        g = g.to(getattr(torch, dtype))
        assert torch.equal(EB.embedding_bag_bwd(g, ids, w, v),
                           EB.embedding_bag_bwd_plain(g, ids, w, v))


@pytest.mark.cuda
def test_cuda_training_lookup_runs_both_kernels(cuda_device):
    g, ids, _ = _t(*_inputs(300, 128, 64, 1, False, seed=12), device=cuda_device)
    table = torch.randn((300, 128), device=cuda_device, requires_grad=True)
    fwd, bwd = EB.launches, EB.bwd_launches
    EB.embedding_bag(table, ids).backward(g)
    torch.cuda.synchronize()
    assert (EB.launches - fwd, EB.bwd_launches - bwd) == (1, 1)
    plain = table.detach().clone().requires_grad_(True)
    EB.embedding_bag_plain_route(plain, ids).backward(g)
    assert torch.equal(table.grad, plain.grad)


@pytest.mark.cuda
def test_cuda_backward_refuses_an_uncompiled_width(cuda_device):
    g, ids, _ = _t(*_inputs(30, 10, 4, 2, False), device=cuda_device)
    before = EB.bwd_launches
    with pytest.raises(ValueError, match="multiple of 4"):
        EB.embedding_bag_bwd(g, ids, None, 30)
    assert EB.bwd_launches == before
