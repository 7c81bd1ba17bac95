"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke).

The port serves the dense GQA family (phi3-mini-3.8b, glm4-9b), the MoE
family (olmoe-1b-7b, granite-moe-3b-a800m) and the SSM family
(falcon-mamba-7b); the other architectures of the JAX package's registry
come with their families."""
from importlib import import_module
from typing import List

_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "glm4-9b": "glm4_9b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced()
