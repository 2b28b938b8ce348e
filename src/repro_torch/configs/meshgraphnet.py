"""meshgraphnet [arXiv:2010.03409]: encode-process-decode GNN, 15 layers, sum agg."""
from repro_torch.configs.base import GNN_SHAPES, GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet",
    n_layers=15,
    d_hidden=128,
    mlp_layers=2,
    aggregator="sum",
)
SHAPES = GNN_SHAPES
