"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].
The CNN feature extractor is a STUB: input_specs provides precomputed frame
embeddings; no autoregressive decode (decode shapes are skipped)."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio", n_layers=48, d_model=1280,
    n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504, causal=False,
    rope=True, frontend="audio")

def reduced() -> ModelConfig:
    return ModelConfig(
        name="hubert-smoke", family="audio", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=32, causal=False,
        rope=True, frontend="audio")
