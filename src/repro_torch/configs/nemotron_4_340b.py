"""nemotron-4-340b — dense GQA kv=8, squared-ReLU FFN [arXiv:2402.16819]."""
from ..config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense", n_layers=96, d_model=18432,
    n_heads=96, n_kv_heads=8, d_ff=73728, vocab=256000, ffn_act="relu2")

def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=2, d_ff=256, vocab=128, ffn_act="relu2")
