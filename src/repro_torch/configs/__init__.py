"""Architecture registry of the port: ``--arch <id>`` -> ArchConfig.

Only the architectures the port can serve are registered (the dense
family's qwen1.5-0.5b, the hybrid family's recurrentgemma-2b and the ssm
family's xlstm-350m); the others arrive with their slices.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: F401

_ARCH_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG
