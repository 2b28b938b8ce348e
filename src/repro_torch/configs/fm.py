"""fm [Rendle ICDM'10]: factorization machine, O(nk) sum-square pairwise trick."""
from repro_torch.configs.base import RECSYS_SHAPES, RecsysConfig

# 39 sparse fields (13 bucketized dense + 26 categorical, Criteo convention).
CONFIG = RecsysConfig(
    name="fm",
    kind="fm",
    embed_dim=10,
    n_sparse=39,
    vocab_sizes=tuple([1000] * 13 + [1000000] * 26),
    interaction="fm-2way",
)
SHAPES = RECSYS_SHAPES
