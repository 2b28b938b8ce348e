"""Config dataclasses: the text-pair family (the paper's own model), the LM
transformers and the recsys models, plus the input-shape specs of their
cells.

The GNN family follows with its models.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Shape specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell.

    kind:
      lm:      "train" | "prefill" | "decode" | "long_decode"
      gnn:     "graph_full" | "graph_sampled" | "graph_batched"
      recsys:  "rec_train" | "rec_serve" | "rec_retrieval"
      textpair:"pair_train" | "pair_serve"
    """
    name: str
    kind: str
    # LM dims
    seq_len: int = 0
    global_batch: int = 0
    # GNN dims
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    n_graphs: int = 0
    # recsys dims
    batch: int = 0
    n_candidates: int = 0


# ---------------------------------------------------------------------------
# LM transformers (dense + MoE)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoESpec:
    n_routed: int
    top_k: int
    n_shared: int
    d_expert: int
    capacity_factor: float = 1.25
    # tokens per dispatch group; groups shard over the data axes.
    group_size: int = 2048


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    qk_norm: bool = False
    rope_theta: float = 10000.0
    moe: Optional[MoESpec] = None
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    # "flash": the causal GQA attention kernel (the default);
    # "chunked": q-chunked materialized-softmax attention in plain torch
    attn_impl: str = "flash"
    # int8 KV cache with per-(token, head) scales (KIVI-style)
    kv_quant: bool = False
    # chunk size (q-chunk for "chunked", kv-chunk for "flash")
    attn_chunk: int = 512
    family: str = "lm"

    @property
    def vocab_padded(self) -> int:
        """Megatron-style vocab padding: the embedding/head tables round up
        to a multiple of 128; logits at padded columns are masked before
        any softmax."""
        return ((self.vocab_size + 127) // 128) * 128

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.d_head * 2  # q, o
        attn += d * self.n_kv_heads * self.d_head * 2  # k, v
        if self.moe is not None:
            ffn = (self.moe.n_routed + self.moe.n_shared) * 3 * d * self.moe.d_expert
            ffn += d * self.moe.n_routed  # router
        else:
            ffn = 3 * d * self.d_ff
        return emb + L * (attn + ffn)

    def n_active_params(self) -> int:
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv_heads * self.d_head * 2
        if self.moe is not None:
            ffn = (self.moe.top_k + self.moe.n_shared) * 3 * d * self.moe.d_expert
            ffn += d * self.moe.n_routed
        else:
            ffn = 3 * d * self.d_ff
        return emb + L * (attn + ffn)


LM_SHAPES = (
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "long_decode", seq_len=524288, global_batch=1),
)


# ---------------------------------------------------------------------------
# RecSys
# ---------------------------------------------------------------------------

# Criteo-1TB per-field vocabulary sizes (MLPerf DLRM reference).
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                       # "fm" | "dlrm" | "din" | "bert4rec"
    embed_dim: int
    n_dense: int = 0
    n_sparse: int = 0
    vocab_sizes: Tuple[int, ...] = ()
    # dlrm
    bot_mlp: Tuple[int, ...] = ()
    top_mlp: Tuple[int, ...] = ()
    interaction: str = ""
    # din
    seq_len: int = 0
    attn_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    # bert4rec
    n_blocks: int = 0
    n_heads: int = 0
    n_items: int = 0
    # training
    n_negatives: int = 1024         # sampled-softmax negatives (bert4rec)
    dtype: str = "bfloat16"
    family: str = "recsys"

    @property
    def total_vocab(self) -> int:
        return sum(self.vocab_sizes) + self.n_items

    def n_params(self) -> int:
        p = self.total_vocab * self.embed_dim
        def mlp_p(dims):
            return sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        if self.kind == "fm":
            p += self.total_vocab  # linear term
        elif self.kind == "dlrm":
            p += mlp_p((self.n_dense,) + self.bot_mlp)
            n_f = self.n_sparse + 1
            d_int = n_f * (n_f - 1) // 2 + self.bot_mlp[-1]
            p += mlp_p((d_int,) + self.top_mlp)
        elif self.kind == "din":
            d = self.embed_dim
            p += mlp_p((4 * d,) + self.attn_mlp + (1,))
            p += mlp_p((2 * d,) + self.mlp + (1,))
        elif self.kind == "bert4rec":
            d = self.embed_dim
            p += self.seq_len * d  # positional
            p += self.n_blocks * (4 * d * d + 8 * d * d)
        return p


RECSYS_SHAPES = (
    ShapeSpec("train_batch", "rec_train", batch=65536),
    ShapeSpec("serve_p99", "rec_serve", batch=512),
    ShapeSpec("serve_bulk", "rec_serve", batch=262144),
    ShapeSpec("retrieval_cand", "rec_retrieval", batch=1, n_candidates=1000000),
)


# ---------------------------------------------------------------------------
# Text-pair CNN (the paper's own model)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TextPairConfig:
    name: str = "sm-cnn"
    vocab_size: int = 30000
    embed_dim: int = 50
    conv_filters: int = 100
    filter_width: int = 5
    n_extra_feats: int = 4
    n_hidden: int = 204            # 2*filters + extra
    max_len: int = 64
    dtype: str = "float32"
    family: str = "textpair"

    def n_params(self) -> int:
        p = self.vocab_size * self.embed_dim
        p += 2 * (self.filter_width * self.embed_dim * self.conv_filters + self.conv_filters)
        j = 2 * self.conv_filters + self.n_extra_feats
        p += j * self.n_hidden + self.n_hidden
        p += self.n_hidden * 2 + 2
        return p


def reduced(cfg):
    """A tiny same-family config for CPU smoke tests."""
    if isinstance(cfg, LMConfig):
        moe = None
        if cfg.moe is not None:
            moe = MoESpec(n_routed=8, top_k=2, n_shared=min(cfg.moe.n_shared, 1),
                          d_expert=32, capacity_factor=1.5, group_size=64)
        return dataclasses.replace(
            cfg, name=cfg.name + "-smoke", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=min(cfg.n_kv_heads, 2), d_head=16, d_ff=128,
            vocab_size=256, moe=moe, dtype="float32", attn_chunk=16)
    if isinstance(cfg, RecsysConfig):
        kw = dict(name=cfg.name + "-smoke", embed_dim=8, dtype="float32",
                  n_negatives=16)
        if cfg.vocab_sizes:
            kw["vocab_sizes"] = tuple(min(v, 50) for v in cfg.vocab_sizes)
        if cfg.n_items:
            kw["n_items"] = 100
        if cfg.seq_len:
            kw["seq_len"] = min(cfg.seq_len, 16)
        if cfg.kind == "dlrm":
            kw["bot_mlp"] = (16, 8)
            kw["top_mlp"] = (16, 8, 1)
        if cfg.kind == "din":
            kw["attn_mlp"] = (8, 4)
            kw["mlp"] = (16, 8)
        return dataclasses.replace(cfg, **kw)
    if isinstance(cfg, TextPairConfig):
        return dataclasses.replace(cfg, name=cfg.name + "-smoke", vocab_size=200,
                                   embed_dim=8, conv_filters=12, n_hidden=28,
                                   max_len=16)
    raise TypeError(type(cfg))
