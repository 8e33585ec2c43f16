"""Architecture registry of the port: ``--arch <id>`` -> ArchConfig.

Only the architectures the port can serve are registered: the dense
family's qwen1.5-0.5b, yi-9b, phi3-medium-14b and minitron-8b (the
squared-ReLU MLP), the hybrid family's recurrentgemma-2b, the ssm
family's xlstm-350m, the MoE family's deepseek-moe-16b and
llama4-maverick-400b-a17b, the encdec family's seamless-m4t-medium and
the vlm family's paligemma-3b. llama4-maverick-400b-a17b does not fit
one card; the port serves its ``reduced()`` form.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig, ShapeConfig  # noqa: F401

_ARCH_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "yi-9b": "yi_9b",
    "phi3-medium-14b": "phi3_medium_14b",
    "minitron-8b": "minitron_8b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "xlstm-350m": "xlstm_350m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "paligemma-3b": "paligemma_3b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_arch(arch_id: str) -> ArchConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG
