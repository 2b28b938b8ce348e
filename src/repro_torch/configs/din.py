"""din [arXiv:1706.06978]: Deep Interest Network, target-attention over history."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="din",
    kind="din",
    embed_dim=18,
    seq_len=100,
    attn_mlp=(80, 40),
    mlp=(200, 80),
    n_items=1000000,
    interaction="target-attn",
)
SHAPES = RECSYS_SHAPES
