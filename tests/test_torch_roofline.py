"""The port's roofline (``repro_torch.roofline``) and the config registry it
reads, against the JAX package's ``repro.roofline`` and ``repro.configs``.

Configs and the model counts (``model_flops``, ``model_bytes``) equal the
JAX package's for every registered architecture and every cell. The counter
(``counts.count``) reads, on the port's eager programs, the FLOPs that
``hlo_parse.analyze`` reads on the JAX programs compiled on the CPU; where
they differ (the port's attention counts the causal half, JAX's kv-chunked
scan every chunk; the bag's adds, which a gather has none of) the test
writes the difference as a formula. Under the counter a hand-kernel wrapper
reads its work formula on either route, forward and backward. The bounds
reproduce the figures ``PERF.md`` records.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as J
from repro.models import recsys as jax_rec, sm_cnn as jax_sm_cnn, transformer as jax_tfm
from repro.roofline import analysis as jax_analysis
from repro.roofline.hlo_parse import analyze
from repro_torch import configs as C
from repro_torch.configs import ShapeSpec, get_config, reduced
from repro_torch.data import recsys as rec_data
from repro_torch.kernels import embedding_bag as EB, flash_attention as FA, sm_cnn_conv as K
from repro_torch.kernels import ops as kops
from repro_torch.core import backends
from repro_torch.models import recsys as rec, sm_cnn, transformer as tfm
from repro_torch.roofline import analysis as A, counts, hw

torch.set_num_threads(2)
ARCHS = sorted(J._MODULES)
CELLS = [(a, s.name) for a, s in C.cells(include_inapplicable=True)] + \
    [("sm-cnn", "pair_train"), ("sm-cnn", "pair_serve")]


def _hlo_flops(fn, *args) -> float:
    """hlo_parse's FLOPs of ``fn`` compiled on the CPU."""
    return analyze(jax.jit(fn).lower(*args).compile().as_text(), 1).flops


# ----------------------------------------------------------------- configs --

@pytest.mark.parametrize("arch", ARCHS)
def test_config_shapes_and_cells_match_jax(arch):
    cfg, jcfg = get_config(arch), J.get_config(arch)
    assert type(cfg).__name__ == type(jcfg).__name__
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    shapes, jshapes = C.get_shapes(arch), J.get_shapes(arch)
    assert [dataclasses.asdict(s) for s in shapes] == [dataclasses.asdict(s) for s in jshapes]
    assert [s.describe() for s in shapes] == [s.describe() for s in jshapes]
    for s, js in zip(shapes, jshapes):
        assert C.shape_applicable(cfg, s) == J.shape_applicable(jcfg, js)
    if cfg.family == "gnn":
        assert [cfg.n_params(s.d_feat) for s in shapes] == \
            [jcfg.n_params(s.d_feat) for s in jshapes]
    else:
        assert cfg.n_params() == jcfg.n_params()
    if cfg.family == "lm":
        assert cfg.n_active_params() == jcfg.n_active_params()
        assert cfg.sub_quadratic == jcfg.sub_quadratic
        assert cfg.vocab_padded == jcfg.vocab_padded


def test_registry_lists_the_jax_cells():
    assert C.ASSIGNED_ARCHS == J.ASSIGNED_ARCHS
    for inapplicable in (False, True):
        assert [(a, dataclasses.asdict(s)) for a, s in C.cells(inapplicable)] == \
            [(a, dataclasses.asdict(s)) for a, s in J.cells(inapplicable)]
    assert len(C.cells(include_inapplicable=True)) == 40
    # the architectures the launcher trains: every one the JAX launcher
    # offers, since the MoE configs train
    assert set(C.ARCHS) == set(J.ASSIGNED_ARCHS) | {"sm-cnn"}
    assert {"deepseek-moe-16b", "moonshot-v1-16b-a3b"} <= set(C.ARCHS)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


# ------------------------------------------------------------ model counts --

@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_counts_equal_jax(arch, shape):
    assert A.model_flops(arch, shape) == jax_analysis.model_flops(arch, shape)
    assert A.model_bytes(arch, shape) == jax_analysis.model_bytes(arch, shape)
    spec = next(s for s in C.get_shapes(arch) if s.name == shape)
    assert A.model_flops(arch, spec) == A.model_flops(arch, shape)
    assert A.model_bytes(arch, spec) == A.model_bytes(arch, shape)


def test_a_cut_shape_reads_its_own_counts():
    """The LM train cell cut to 4 x 2048, as chip_smoke.py runs it: 6 N T
    plus the attention at 3x its forward, over the cut tokens."""
    cfg = get_config("qwen3-0.6b")
    b, s = 4, 2048
    cut = ShapeSpec("train_4k", "train", seq_len=s, global_batch=b)
    want = 6.0 * cfg.n_active_params() * b * s + \
        3.0 * 2.0 * 2.0 * b * cfg.n_layers * cfg.n_heads * cfg.d_head * s * s * 0.5
    assert A.model_flops("qwen3-0.6b", cut) == want
    assert A.model_bytes("qwen3-0.6b", cut) == \
        cfg.n_params() * 28.0 + b * s * cfg.d_model * cfg.n_layers * 4.0


# ------------------------------------------------------ counter against JAX --

def test_sm_cnn_eager_forward_counts_what_hlo_parse_counts():
    cfg = get_config("sm-cnn")
    tree = sm_cnn.init_sm_cnn_numpy(cfg, seed=0)
    rng = np.random.default_rng(0)
    q = rng.integers(0, cfg.vocab_size, (64, cfg.max_len)).astype(np.int32)
    a = rng.integers(0, cfg.vocab_size, (64, cfg.max_len)).astype(np.int32)
    f = rng.standard_normal((64, cfg.n_extra_feats)).astype(np.float32)
    params = sm_cnn.params_from_numpy(tree, "cpu")
    got = counts.count(sm_cnn.forward, params, torch.from_numpy(q), torch.from_numpy(a),
                       torch.from_numpy(f), cfg).flops
    jcfg = J.get_config("sm-cnn")
    jp = jax.tree.map(jnp.asarray, tree)
    want = _hlo_flops(lambda p, q_, a_, f_: jax_sm_cnn.forward(p, q_, a_, f_, jcfg),
                      jp, q, a, f)
    assert got == want == A.model_flops("sm-cnn", "pair_serve") == 440_579_072
    # the eager scorer (numpy rows in, inference mode inside) reads the same
    scorer = backends.make_scorer("eager", tree, cfg, buckets=(64,), device="cpu")
    assert counts.count(scorer, q, a, f).flops == got
    # the pallas scorer's convs count as the kernel's formula: the S real rows
    # of each arm, not the S + w - 1 windows of the plain im2col
    w, d, n_f = cfg.filter_width, cfg.embed_dim, cfg.conv_filters
    pallas = counts.count(kops.sm_cnn_score, params, torch.from_numpy(q),
                          torch.from_numpy(a), torch.from_numpy(f), cfg).flops
    assert got - pallas == 2 * 2 * 64 * (w - 1) * w * d * n_f


@pytest.mark.parametrize("impl,b,s", [("chunked", 2, 16), ("chunked", 1, 48),
                                      ("flash", 2, 16), ("flash", 1, 48), ("flash", 2, 40)])
def test_lm_forward_counts_what_hlo_parse_counts(impl, b, s):
    """reduced(qwen3-0.6b): the products outside attention are equal. With
    ``chunked`` both packages score every (query, key) pair of a chunk of
    queries, so all are equal. With ``flash`` JAX's scan scores every pair
    of its kv chunks, S x S_pad with S_pad the keys padded to attn_chunk,
    while the port's kernel wrapper counts the causal half S(S+1)/2. (JAX's
    chunked attention takes S a multiple of its chunk of 16.)"""
    jcfg = dataclasses.replace(J.reduced(J.get_config("qwen3-0.6b")), remat=False,
                               attn_impl=impl)
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")), attn_impl=impl)
    jp = jax_tfm.init_lm(jax.random.PRNGKey(0), jcfg)
    tp = tfm.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    want = _hlo_flops(lambda p, t: jax_tfm.forward(p, t, jcfg), jp, tok)
    with torch.no_grad():
        got = counts.count(tfm.forward, tp, torch.from_numpy(tok), cfg).flops
    if impl == "chunked":
        assert got == want
    else:
        per_pair = 4 * b * cfg.n_layers * cfg.n_heads * cfg.d_head
        s_pad = -(-s // cfg.attn_chunk) * cfg.attn_chunk
        assert want - per_pair * s * s_pad == got - per_pair * s * (s + 1) // 2


@pytest.mark.parametrize("batch", [1, 64])
def test_dlrm_serve_step_counts_what_hlo_parse_counts(batch):
    """reduced(dlrm-mlperf): every product equal; the port adds the bag
    kernel's formula, the B x F x d adds of its one-row bags, which JAX's
    gather does not count."""
    jcfg = J.reduced(J.get_config("dlrm-mlperf"))
    cfg = reduced(get_config("dlrm-mlperf"))
    jp = jax_rec.init_model(jax.random.PRNGKey(0), jcfg)
    tp = rec.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    b = rec_data.batch_for(cfg, batch, seed=5)
    want = _hlo_flops(lambda p, x: jax_rec.serve_step(p, x, jcfg), jp,
                      {k: jnp.asarray(v) for k, v in b.items()})
    tb = {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    with torch.no_grad():
        got = counts.count(rec.serve_step, tp, tb, cfg).flops
        plain = counts.count(rec.serve_step, tp, tb, cfg, lookup="plain").flops
    assert got == plain == want + batch * cfg.n_sparse * cfg.embed_dim


# ------------------------------------------------ kernels count as formulas --

def _same(c, work):
    assert (c.flops, c.bytes_accessed) == tuple(float(x) for x in work)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_counts_as_its_formula(dtype):
    b, s, d, w, f = 4, 16, 8, 5, 12
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, s, d), generator=gen).to(dtype)
    filt = torch.randn((w * d, f), generator=gen).to(dtype)
    bias = torch.randn((f,), generator=gen).to(dtype)
    work = A.conv_tanh_maxpool_work(b, s, d, w, f, dtype)
    _same(counts.count(K.conv_tanh_maxpool, x, filt, bias, w), work)
    plain = counts.count(K.conv_tanh_maxpool_plain, x, filt, bias, w)
    assert plain.flops == 2 * b * (s + w - 1) * w * d * f != work[0]


def _qkv(b, s, h, hkv, d, dtype, grad=False):
    gen = torch.Generator().manual_seed(1)
    return [torch.randn((b, s, n, d), generator=gen).to(dtype).requires_grad_(grad)
            for n in (h, hkv, hkv)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_counts_as_its_formula_both_ways(dtype):
    b, s, h, hkv, d = 2, 9, 4, 2, 16
    q, k, v = _qkv(b, s, h, hkv, d, dtype)
    _same(counts.count(FA.flash_attention, q, k, v), A.attention_work(b, s, h, hkv, d, dtype))
    assert counts.count(FA.flash_attention_plain, q, k, v).flops == 4 * b * h * d * s * s
    q, k, v = _qkv(b, s, h, hkv, d, dtype, grad=True)

    def step():
        FA.flash_attention(q, k, v).float().sum().backward()
    c = counts.count(step)
    fwd = A.attention_work(b, s, h, hkv, d, dtype, lse=True)
    bwd = A.attention_bwd_work(b, s, h, hkv, d, dtype)
    assert c.flops == fwd[0] + bwd[0] == 12 * b * h * d * s * (s + 1) // 2
    # the plain backward's own products are not counted: only the formula's
    # and none of the loss's (a sum is not a product)
    assert q.grad is not None and k.grad is not None and v.grad is not None
    # bytes: the formulas' plus the loss's own aten ops outside the kernels
    assert c.bytes_accessed >= fwd[1] + bwd[1]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bag_counts_as_its_formula_both_ways(weighted, dtype):
    v_rows, d, b, l = 50, 8, 6, 3
    gen = torch.Generator().manual_seed(2)
    table = torch.randn((v_rows, d), generator=gen).to(dtype)
    ids = torch.randint(0, v_rows, (b, l), generator=gen, dtype=torch.int32)
    ids[0, 1] = ids[0, 0]   # a repeated row is read once
    w = torch.rand((b, l), generator=gen) if weighted else None
    work = A.embedding_bag_work(ids, weighted, d, dtype)
    _same(counts.count(EB.embedding_bag, table, ids, w), work)
    _same(counts.count(EB.embedding_bag_plain_route, table, ids, w), work)
    g = torch.randn((b, d), generator=gen).to(dtype)
    bwd = A.embedding_bag_bwd_work(ids, weighted, d, v_rows, dtype)
    _same(counts.count(EB.embedding_bag_bwd, g, ids, w, v_rows), bwd)
    for route in (EB.embedding_bag, EB.embedding_bag_plain_route):
        live = table.clone().requires_grad_(True)

        def step():
            torch.autograd.backward(route(live, ids, w), g)
        c = counts.count(step)
        assert (c.flops, c.bytes_accessed) == (work[0] + bwd[0], work[1] + bwd[1])
        assert live.grad is not None


def test_a_region_inside_a_region_records_nothing():
    with counts.Counter() as counter:
        with counts.kernel(lambda: (10, 100)):
            torch.ones(4) + 1       # inside a kernel: not counted
            with counts.kernel(lambda: (1, 1)):
                pass
        assert (counter.counts.flops, counter.counts.bytes_accessed) == (10, 100)
    # no counter: the formula is never evaluated
    with counts.kernel(lambda: 1 / 0):
        pass


# ------------------------------------------------------------------ bounds --

@pytest.mark.parametrize("work,dtype,ms", [
    (A.attention_work(8, 2048, 16, 8, 128, "bfloat16"), "bfloat16", 0.13904),
    (A.attention_bwd_work(4, 2048, 16, 8, 128, "bfloat16"), "bfloat16", 0.13904),
    (A.conv_tanh_maxpool_work(256, 64, 50, 5, 100, "bfloat16"), "bfloat16", 0.00083),
    (A.conv_tanh_maxpool_work(256, 64, 50, 5, 100, "float32"), "float32", 0.00496),
    (A.attention_work(8, 2048, 16, 8, 128, "float32"), "float32", 0.83337),
], ids=["attn-bf16-8x2048", "attn-bwd-bf16-4x2048", "conv-bf16-256", "conv-f32-256",
        "attn-f32-8x2048"])
def test_bounds_reproduce_the_recorded_figures(work, dtype, ms):
    got = A.bound(*work, dtype)
    assert round(got.ms, 5) == ms and got.by == "operations"


def test_float32_products_take_the_3xtf32_rate():
    assert hw.peak_flops("float32") == hw.peak_flops(torch.float32) == 495e12 / 3
    assert hw.peak_flops("bfloat16") == hw.peak_flops(torch.float16) == 989e12
    assert hw.peak_flops("float32", products=False) == 67e12
    with pytest.raises(ValueError):
        hw.peak_flops("int32")
    for dt, n in hw.DTYPE_BYTES.items():
        assert torch.empty((), dtype=dt).element_size() == n
    # a bag is bound by its bytes; its adds are read at the CUDA cores' rate
    ids = torch.arange(13312, dtype=torch.int32).view(-1, 1)
    bag = A.bound(*A.embedding_bag_work(ids, False, 128, "bfloat16"), "bfloat16",
                  products=False)
    assert bag.by == "bytes" and bag.peak == 67e12


@pytest.mark.parametrize("flops,n_bytes,link,bottleneck", [
    (989e12 * 2, 3.35e12, 0.0, "compute"),
    (989e12, 3.35e12 * 3, 0.0, "memory"),
    (0.0, 0.0, 450e9 * 5, "collective"),
])
def test_build_roofline_reads_a_hand_built_count(flops, n_bytes, link, bottleneck):
    c = counts.Counts(flops=flops, bytes_accessed=n_bytes, link_bytes=link)
    shape = ShapeSpec("train_4k", "train", seq_len=2048, global_batch=4)
    r = A.build_roofline("qwen3-0.6b", shape, "1", 1, c)
    assert r.bottleneck == bottleneck
    assert r.step_s == max(flops / 989e12, n_bytes / 3.35e12, link / 450e9)
    mfl, mby = A.model_flops("qwen3-0.6b", shape), A.model_bytes("qwen3-0.6b", shape)
    ideal = max(mfl / 989e12, mby / 3.35e12)
    assert r.bound_s == ideal and r.bound_by == "operations"
    assert math.isclose(r.roofline_frac, ideal / r.step_s)
    assert r.useful_ratio == mfl / max(flops, 1.0)
    assert r.share(2 * ideal) == 0.5
    # sm-cnn is float32: its compute term is read at the 3xTF32 rate
    r32 = A.build_roofline("sm-cnn", "pair_serve", "1", 1, c)
    assert r32.compute_s == flops / 165e12


# ------------------------------------------------------------------- bytes --

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_matmul_reads_its_operands_and_writes_its_result(dtype):
    m, k, n = 5, 7, 3
    a, b = torch.ones((m, k), dtype=dtype), torch.ones((k, n), dtype=dtype)
    c = counts.count(torch.mm, a, b)
    assert c.bytes_accessed == (m * k + k * n + m * n) * a.element_size()
    assert c.flops == 2 * m * k * n


def test_a_program_of_views_reads_nothing():
    x = torch.arange(24.0)

    def views():
        y = x.view(2, 3, 4).transpose(0, 2)[1:].unsqueeze(0).permute(3, 0, 1, 2)
        return y.expand(2, -1, -1, -1, -1)[0].squeeze(1).narrow(0, 1, 1).detach()
    c = counts.count(views)
    assert (c.flops, c.bytes_accessed) == (0.0, 0.0)
