"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke).

This slice of the port serves the dense GQA family; the other
architectures of the JAX package's registry come with their families."""
from importlib import import_module
from typing import List

_MODULES = {
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "glm4-9b": "glm4_9b",
}

ARCHS: List[str] = list(_MODULES)


def get_config(arch: str):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str):
    mod = import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced()
