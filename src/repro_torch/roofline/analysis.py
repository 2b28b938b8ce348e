"""Three-term roofline of a step on the H100, the model cells' useful work,
and the work and bound of each hand-written kernel call.

  compute    = FLOPs / (chips x peak of the config's dtype)   [counted]
  memory     = bytes / (chips x HBM rate)
  collective = link bytes a device / NVLink rate              [0 at world size 1]

plus MODEL_FLOPS (6*N*D train / 2*N*D inference, N_active for MoE), the
irreducible MODEL_BYTES, and the useful-compute ratio MODEL_FLOPS /
counted FLOPs. ``model_flops`` and ``model_bytes`` are the JAX package's
formulas unchanged (``src/repro/roofline/analysis.py``); they take a cell's
shape by name, or as a ``ShapeSpec`` for a cell cut to fit the card.

The bound of a step or a call is the least time the card could take for
its work: the larger of its bytes at the HBM rate and its operations at the
peak of their type (``hw.peak_flops``: a float32 product at the 3xTF32 rate,
495e12 / 3 FLOP/s). The kernel formulas below count each input read once and
each output written once, and only the work the inputs need: the causal
half of attention, the S real rows of the conv, the distinct rows a bag
names.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple, Union

from repro_torch.configs import get_config, get_shapes
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig, ShapeSpec, TextPairConfig
from repro_torch.roofline import hw
from repro_torch.roofline.counts import Counts


def _shape(arch: str, shape: Union[str, ShapeSpec]) -> ShapeSpec:
    if isinstance(shape, ShapeSpec):
        return shape
    return next(s for s in get_shapes(arch) if s.name == shape)


def _mlp_flops(dims, n: int) -> float:
    return sum(2.0 * a * b for a, b in zip(dims[:-1], dims[1:])) * n


def model_flops(arch: str, shape: Union[str, ShapeSpec], cfg=None) -> float:
    """Useful-math FLOPs for one step of the cell (global, not per device);
    ``cfg``, where given, stands for the registered config (a cut one)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = _shape(arch, shape)

    if isinstance(cfg, LMConfig):
        n_act = cfg.n_active_params()
        if shape.kind == "train":
            t = shape.global_batch * shape.seq_len
            base = 6.0 * n_act * t
            attn = 3.0 * 2.0 * 2.0 * shape.global_batch * cfg.n_layers * \
                cfg.n_heads * cfg.d_head * shape.seq_len ** 2 * 0.5
            return base + attn
        if shape.kind == "prefill":
            t = shape.global_batch * shape.seq_len
            attn = 2.0 * 2.0 * shape.global_batch * cfg.n_layers * \
                cfg.n_heads * cfg.d_head * shape.seq_len ** 2 * 0.5
            return 2.0 * n_act * t + attn
        # decode: one token per sequence + attention over the full cache
        t = shape.global_batch
        attn = 2.0 * 2.0 * t * cfg.n_layers * cfg.n_heads * cfg.d_head * shape.seq_len
        return 2.0 * n_act * t + attn

    if isinstance(cfg, GNNConfig):
        h = cfg.d_hidden
        mlp = lambda i, o: [i] + [h] * cfg.mlp_layers + [o]  # noqa: E731
        n, e = shape.n_nodes, shape.n_edges
        enc = _mlp_flops(mlp(shape.d_feat, h), n) + _mlp_flops(mlp(cfg.d_edge_in, h), e)
        proc = cfg.n_layers * (_mlp_flops(mlp(3 * h, h), e) + _mlp_flops(mlp(2 * h, h), n))
        dec = _mlp_flops(mlp(h, cfg.d_out), n)
        per_graph = enc + proc + dec
        mult = shape.n_graphs or 1
        fwd = per_graph * mult
        return 3.0 * fwd if shape.kind != "rec_serve" else fwd  # train: fwd+bwd

    if isinstance(cfg, RecsysConfig):
        d = cfg.embed_dim

        def fwd_per_example() -> float:
            if cfg.kind == "fm":
                return 2.0 * cfg.n_sparse * d * 2
            if cfg.kind == "dlrm":
                f = _mlp_flops((cfg.n_dense,) + cfg.bot_mlp, 1)
                n_f = cfg.n_sparse + 1
                f += 2.0 * n_f * n_f * d
                d_int = n_f * (n_f - 1) // 2 + cfg.bot_mlp[-1]
                f += _mlp_flops((d_int,) + cfg.top_mlp, 1)
                return f
            if cfg.kind == "din":
                f = _mlp_flops((4 * d,) + cfg.attn_mlp + (1,), cfg.seq_len)
                f += 2.0 * cfg.seq_len * d
                f += _mlp_flops((2 * d,) + cfg.mlp + (1,), 1)
                return f
            # bert4rec encode: per-token attn+ffn over seq
            s = cfg.seq_len
            per_tok = 2.0 * (4 * d * d + 8 * d * d) + 2.0 * 2.0 * s * d
            return per_tok * s
        if shape.kind == "rec_train":
            extra = 0.0
            if cfg.kind == "bert4rec":
                extra = 2.0 * cfg.n_negatives * d
            return 3.0 * shape.batch * (fwd_per_example() + extra)
        if shape.kind == "rec_serve":
            return shape.batch * fwd_per_example()
        # retrieval
        if cfg.kind in ("fm", "bert4rec"):
            return fwd_per_example() + 2.0 * shape.n_candidates * d
        return shape.n_candidates * fwd_per_example()

    if isinstance(cfg, TextPairConfig):
        w, d, f = cfg.filter_width, cfg.embed_dim, cfg.conv_filters
        per_arm = 2.0 * (cfg.max_len + w - 1) * w * d * f
        j = 2 * f + cfg.n_extra_feats
        per_pair = 2 * per_arm + 2.0 * (j * cfg.n_hidden + cfg.n_hidden * 2)
        mult = 3.0 if shape.kind == "pair_train" else 1.0
        return mult * shape.batch * per_pair

    raise TypeError(type(cfg))


def model_bytes(arch: str, shape: Union[str, ShapeSpec], cfg=None) -> float:
    """Irreducible GLOBAL bytes one step must move through HBM (the memory-
    roofline floor): weights/optimizer state touched once, the KV cache read
    once (decode), per-layer residual/message streams written+read once.
    Deliberately optimistic — the fraction vs this floor is the score.
    ``cfg``, where given, stands for the registered config (a cut one)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = _shape(arch, shape)

    if isinstance(cfg, LMConfig):
        n_p = cfg.n_params()
        if shape.kind == "train":
            t = shape.global_batch * shape.seq_len
            # bf16 param r/w (4) + fp32 m,v r/w (16) + master r/w (8) = 28
            return n_p * 28.0 + t * cfg.d_model * cfg.n_layers * 2 * 2.0
        if shape.kind == "prefill":
            t = shape.global_batch * shape.seq_len
            cache = 2 * cfg.n_layers * t * cfg.n_kv_heads * cfg.d_head * 2.0
            return n_p * 2.0 + cache + t * cfg.d_model * cfg.n_layers * 2 * 2.0
        # decode: weights + full cache read once
        cache = 2 * cfg.n_layers * shape.global_batch * shape.seq_len * \
            cfg.n_kv_heads * cfg.d_head * 2.0
        return n_p * 2.0 + cache

    if isinstance(cfg, GNNConfig):
        h = cfg.d_hidden
        mult = (shape.n_graphs or 1)
        n, e = shape.n_nodes * mult, shape.n_edges * mult
        per_layer = (e * 3 * h + n * 2 * h) * 2.0
        train_mult = 3.0
        io = (n * shape.d_feat + e * cfg.d_edge_in) * 2.0
        return train_mult * cfg.n_layers * per_layer + io

    if isinstance(cfg, RecsysConfig):
        d = cfg.embed_dim
        if shape.kind == "rec_train":
            rows = {"fm": cfg.n_sparse, "dlrm": cfg.n_sparse,
                    "din": cfg.seq_len + 1,
                    "bert4rec": cfg.seq_len + 1 + cfg.n_negatives}[cfg.kind]
            # embedding rows: fwd read + grad scatter r/w (fp32 opt rows x3)
            return shape.batch * rows * d * (2.0 + 12.0)
        if shape.kind == "rec_serve":
            rows = {"fm": cfg.n_sparse, "dlrm": cfg.n_sparse,
                    "din": cfg.seq_len + 1, "bert4rec": cfg.seq_len + 1}[cfg.kind]
            return shape.batch * rows * d * 2.0
        return shape.n_candidates * d * 2.0  # candidate rows read once

    if isinstance(cfg, TextPairConfig):
        per_pair = 2 * cfg.max_len * cfg.embed_dim * 4.0
        return shape.batch * (per_pair + cfg.n_params() * 0)  # streams dominate

    raise TypeError(type(cfg))


# ------------------------------------------------------------------ bounds --

class Bound(NamedTuple):
    """The least time of some work on the card: ``ms``, what bounds it
    (``by``: "bytes" or "operations"), the work, and the peak rate its
    operations were read at."""
    ms: float
    by: str
    ops: float
    n_bytes: float
    peak: float


def bound(ops: float, n_bytes: float, dtype, products: bool = True) -> Bound:
    """The larger of ``n_bytes`` at the HBM rate and ``ops`` at the peak of
    ``dtype`` (``hw.peak_flops``; ``products=False`` for adds and other
    work off the tensor cores)."""
    peak = hw.peak_flops(dtype, products)
    t_bytes = n_bytes / hw.HBM_BW * 1e3
    t_ops = ops / peak * 1e3
    return Bound(max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations",
                 ops, n_bytes, peak)


def _size(dtype) -> int:
    return hw.DTYPE_BYTES[hw.as_dtype(dtype)]


def conv_tanh_maxpool_work(b: int, s: int, d: int, w: int, f: int,
                           dtype) -> Tuple[float, float]:
    """(operations, bytes) of the fused conv: x, the filters and the bias
    read once and the (B, F) output written once; the multiply-adds of each
    of the S real rows with each of the w taps. Products with the zero pad
    rows are not needed, so they are not counted."""
    es = _size(dtype)
    return 2 * b * s * w * d * f, (b * s * d + w * d * f + f + b * f) * es


def attention_work(b: int, s: int, h: int, hkv: int, d: int, dtype,
                   lse: bool = False) -> Tuple[float, float]:
    """(operations, bytes) of causal GQA attention: q, k, v read once and o
    written once (and with ``lse`` each row's float32 log-sum-exp), against
    two products of d terms for each visible (query, key) pair, S(S+1)/2 of
    them per query head (the causal half with the diagonal). Products on
    masked pairs are not needed, so they are not counted."""
    n_bytes = _size(dtype) * b * s * d * (2 * h + 2 * hkv) + (4 * b * h * s if lse else 0)
    return 4 * b * h * d * s * (s + 1) // 2, n_bytes


def attention_bwd_work(b: int, s: int, h: int, hkv: int, d: int,
                       dtype) -> Tuple[float, float]:
    """(operations, bytes) of the attention's gradient: q, k, v, o, do and
    lse read once, dq, dk, dv written once, against the four products of d
    terms it needs for each visible (query, key) pair (dv, dp, dq, dk:
    twice the forward's). The recomputed S is not needed, so it is not
    counted."""
    n_bytes = _size(dtype) * b * s * d * (4 * h + 4 * hkv) + 4 * b * h * s
    return 8 * b * h * d * s * (s + 1) // 2, n_bytes


def embedding_bag_work(ids, weighted: bool, d: int, dtype,
                       n_rows: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) of the bag sum, from this call's ids: the ids
    (and weights) read once, each distinct row they name read once, the
    (B, d) output written once; the d adds (and d multiplies, weighted) of
    each named row. They are not products: bound them with
    ``products=False``. Meta ids hold no values: their distinct rows are
    taken as ``min(B * L, n_rows)``, the most they could name."""
    b, l = ids.shape
    if ids.device.type == "meta":
        distinct = ids.numel() if n_rows is None else min(ids.numel(), n_rows)
    else:
        distinct = int(ids.unique().numel())
    n_bytes = ids.numel() * (4 + (4 if weighted else 0)) + (distinct + b) * d * _size(dtype)
    return b * l * d * (2 if weighted else 1), n_bytes


def embedding_bag_bwd_work(ids, weighted: bool, d: int, v: int,
                           dtype) -> Tuple[float, float]:
    """(operations, bytes) of the dense table gradient: the ids (and
    weights) read once, grad_out's B rows read once and the (V, d) gradient
    written once; the d adds (and d multiplies, weighted) of each position.
    They are not products: bound them with ``products=False``."""
    b, l = ids.shape
    n_bytes = ids.numel() * (4 + (4 if weighted else 0)) + (b + v) * d * _size(dtype)
    return b * l * d * (2 if weighted else 1), n_bytes


# ---------------------------------------------------------------- roofline --

@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops_per_dev: float
    hlo_bytes_per_dev: float
    link_bytes_per_dev: float
    collective_bytes: Dict[str, float]
    n_collectives: Dict[str, int]
    model_flops: float
    model_bytes: float
    #: the model-to-counted FLOP ratio: model_flops over the counted FLOPs
    useful_ratio: float
    bottleneck: str
    step_s: float
    roofline_frac: float
    #: the least time of the model's work on the card (the roofline floor)
    #: and what bounds it, "bytes" or "operations"
    bound_s: float
    bound_by: str

    def row(self) -> Dict:
        return dataclasses.asdict(self)

    def share(self, measured_s: float) -> float:
        """The floor's share of a measured step: 1.0 runs at the bound."""
        return self.bound_s / measured_s


def build_roofline(arch: str, shape: Union[str, ShapeSpec], mesh_name: str,
                   n_devices: int, counts: Counts,
                   mfl: Optional[float] = None, cfg=None) -> Roofline:
    """``hlo_*`` fields hold the counter's numbers (``counts.count``), named
    as the JAX package's report names them; ``cfg``, where given, stands for
    the registered config (a cut one)."""
    shape = _shape(arch, shape)
    cfg = get_config(arch) if cfg is None else cfg
    peak = hw.peak_flops(cfg.dtype)
    mfl = model_flops(arch, shape, cfg) if mfl is None else mfl
    mby = model_bytes(arch, shape, cfg)
    compute_s = counts.flops / peak
    memory_s = counts.bytes_accessed / hw.HBM_BW
    collective_s = counts.link_bytes / hw.NVLINK_BW
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    step_s = max(terms.values())
    # the roofline floor: the step can't be faster than its compute at peak
    # OR its irreducible data movement at full HBM bandwidth
    floor_ops = mfl / (n_devices * peak)
    floor_bytes = mby / (n_devices * hw.HBM_BW)
    ideal_s = max(floor_ops, floor_bytes)
    return Roofline(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        hlo_flops_per_dev=counts.flops,
        hlo_bytes_per_dev=counts.bytes_accessed,
        link_bytes_per_dev=counts.link_bytes,
        collective_bytes=dict(counts.collective_bytes),
        n_collectives=dict(counts.n_collectives),
        model_flops=mfl,
        model_bytes=mby,
        useful_ratio=mfl / max(counts.flops * n_devices, 1.0),
        bottleneck=bottleneck,
        step_s=step_s,
        roofline_frac=ideal_s / max(step_s, 1e-30),
        bound_s=ideal_s,
        bound_by="bytes" if floor_bytes > floor_ops else "operations",
    )
