"""Architecture registry: ``get_config("<arch-id>")``.

The dense qwen3 configurations are ported; the reference's other eight
architectures belong to the training substrate (ROADMAP.md Queue 1 item 13)
and raise here.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = ["qwen3-4b", "qwen3-0.6b"]
UNPORTED_ARCH_IDS = [
    "smollm-360m", "granite-8b", "deepseek-moe-16b", "qwen2-moe-a2.7b",
    "whisper-medium", "hymba-1.5b", "internvl2-2b", "mamba2-1.3b",
]


def _module(arch_id: str):
    if arch_id in UNPORTED_ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP.md Queue 1 item 13)"
        )
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS + UNPORTED_ARCH_IDS}")
    return importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced_config(arch_id: str) -> ModelConfig:
    """Small same-family config for CPU tests."""
    return _module(arch_id).reduced()
