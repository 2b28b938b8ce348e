"""qwen3-0.6b [hf:Qwen/Qwen3-family]: dense, GQA kv=8, qk_norm."""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
)
SHAPES = LM_SHAPES
