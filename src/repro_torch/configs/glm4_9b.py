"""glm4-9b — dense, RoPE, GQA kv=2 [hf:THUDM/glm-4-9b]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=151552)

def reduced() -> ModelConfig:
    return ModelConfig(
        name="glm4-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=128, vocab=128)
