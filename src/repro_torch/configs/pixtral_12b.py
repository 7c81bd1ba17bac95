"""pixtral-12b — pixtral-ViT frontend (stub) + mistral-nemo decoder
[hf:mistralai/Pixtral-12B-2409].  The vision tower is a STUB: input_specs
provides precomputed patch embeddings that replace the first
``n_frontend_tokens`` token positions."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=131072, head_dim=128,
    frontend="vision", n_frontend_tokens=256)

def reduced() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="vlm", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=128, vocab=128, head_dim=8,
        frontend="vision", n_frontend_tokens=8)
