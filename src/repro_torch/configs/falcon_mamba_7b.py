"""falcon-mamba-7b — Mamba-1, attention-free [arXiv:2410.05355]."""
from ..config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    n_heads=1, n_kv_heads=1, d_ff=0, vocab=65024, rope=False,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2))

def reduced() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=1, n_kv_heads=1, d_ff=0, vocab=128, rope=False,
        ssm=SSMConfig(d_state=4, d_conv=4, expand=2))
