"""granite-moe-3b-a800m — MoE 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base]."""
from ..config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
    moe=MoEConfig(num_experts=40, top_k=8, d_ff_expert=512))

def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64))
