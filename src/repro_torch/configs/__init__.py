"""Architecture registry: one module per assigned architecture.

``get_config(name)`` returns the full published config;
``get_tiny(name)`` returns the reduced same-family smoke-test variant.
"""
from __future__ import annotations

import importlib

from repro_torch.models.model import ArchConfig, tiny_variant

ARCH_IDS = [
    "jamba-1.5-large-398b",
    "gemma3-1b",
    "granite-8b",
    "qwen3-4b",
    "h2o-danube-3-4b",
    "mixtral-8x22b",
    "granite-moe-1b-a400m",
    "internvl2-26b",
    "xlstm-1.3b",
    "musicgen-large",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_IDS}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_tiny(name: str) -> ArchConfig:
    mod = importlib.import_module(_MODULES[name])
    if hasattr(mod, "TINY"):
        return mod.TINY
    return tiny_variant(mod.CONFIG)


def all_configs() -> dict[str, ArchConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
