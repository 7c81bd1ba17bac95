"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke).

The JAX package's registry, key for key and in its order: the dense
family with GQA (phi3-mini-3.8b, glm4-9b, nemotron-4-340b) and with MLA
(minicpm3-4b), the MoE family (olmoe-1b-7b, granite-moe-3b-a800m), the SSM
family (falcon-mamba-7b), the hybrid family (recurrentgemma-2b), and the
dense decoder behind a vision frontend (pixtral-12b) or an audio one
(hubert-xlarge, an encoder)."""
from importlib import import_module
from typing import List

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "minicpm3-4b": "minicpm3_4b",
    "nemotron-4-340b": "nemotron_4_340b",
    "glm4-9b": "glm4_9b",
    "pixtral-12b": "pixtral_12b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "hubert-xlarge": "hubert_xlarge",
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced()
