"""olmoe-1b-7b — MoE 64 experts top-8 [arXiv:2409.02060]."""
from ..config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024))

def reduced() -> ModelConfig:
    return ModelConfig(
        name="olmoe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=64, vocab=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64))
