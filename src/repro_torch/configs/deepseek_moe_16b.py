"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE, 2 shared + 64 routed top-6."""
from repro_torch.configs.base import LM_SHAPES, LMConfig, MoESpec

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=102400,
    moe=MoESpec(n_routed=64, top_k=6, n_shared=2, d_expert=1408),
)
SHAPES = LM_SHAPES
