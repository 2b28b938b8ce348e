"""bert4rec [arXiv:1904.06690]: bidirectional self-attention sequential recsys."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="bert4rec",
    kind="bert4rec",
    embed_dim=64,
    n_blocks=2,
    n_heads=2,
    seq_len=200,
    n_items=1000000,
)
SHAPES = RECSYS_SHAPES
