"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 64e top-6 MoE."""
from repro_torch.configs.base import LM_SHAPES, LMConfig, MoESpec

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=163840,
    moe=MoESpec(n_routed=64, top_k=6, n_shared=2, d_expert=1408),
)
SHAPES = LM_SHAPES
