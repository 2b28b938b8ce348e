"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM benchmark config (Criteo 1TB)."""
from repro_torch.configs.base import CRITEO_VOCABS, RECSYS_SHAPES, RecsysConfig

CONFIG = RecsysConfig(
    name="dlrm-mlperf",
    kind="dlrm",
    embed_dim=128,
    n_dense=13,
    n_sparse=26,
    vocab_sizes=CRITEO_VOCABS,
    bot_mlp=(512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    interaction="dot",
)
SHAPES = RECSYS_SHAPES
