"""Config dataclasses: the text-pair family (the paper's own model).

Only the textpair family is ported so far; the LM, GNN and recsys
families follow with their models.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


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
    if isinstance(cfg, TextPairConfig):
        return dataclasses.replace(cfg, name=cfg.name + "-smoke", vocab_size=200,
                                   embed_dim=8, conv_filters=12, n_hidden=28,
                                   max_len=16)
    raise TypeError(type(cfg))
