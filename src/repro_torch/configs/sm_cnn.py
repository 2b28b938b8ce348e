"""sm-cnn: the paper's own model (Severyn & Moschitti 2015, simplified per
Rao et al. 2017 — no bilinear similarity), used by the reranking pipeline."""
from repro_torch.configs.base import TEXTPAIR_SHAPES, TextPairConfig

CONFIG = TextPairConfig(name="sm-cnn")
SHAPES = TEXTPAIR_SHAPES
