"""deepseek-coder-33b [arXiv:2401.14196]: llama-arch dense, GQA kv=8."""
from repro_torch.configs.base import LM_SHAPES, LMConfig

CONFIG = LMConfig(
    name="deepseek-coder-33b",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_head=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
)
SHAPES = LM_SHAPES
