"""recurrentgemma-2b — RG-LRU + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427]."""
from ..config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4, window=2048))

def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid", n_layers=5, d_model=64,
        n_heads=2, n_kv_heads=1, d_ff=128, vocab=128, head_dim=16,
        rglru=RGLRUConfig(lru_width=64, conv_width=4, window=16))
