"""phi3-mini-3.8b — dense, RoPE + SwiGLU, MHA (kv=32) [arXiv:2404.14219]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064)

def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=128)
