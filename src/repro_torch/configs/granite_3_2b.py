"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: dense GQA kv=8."""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="granite-3-2b",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_head=64,
    d_ff=8192,
    vocab_size=49155,
    tie_embeddings=True,
)
SHAPES = LM_SHAPES
