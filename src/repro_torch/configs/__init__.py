"""Assigned-architecture registry: ``get_config(arch_id)``.

Each module defines ``CONFIG`` with the exact published configuration
(source cited in the module docstring).  ``ARCH_IDS`` is the assigned
10-architecture pool.
"""

from __future__ import annotations

import importlib

from .base import ModelConfig, ShapeConfig, SHAPES

ARCH_IDS = [
    "internlm2_1_8b",
    "phi3_medium_14b",
    "qwen3_8b",
    "granite_34b",
    "qwen2_vl_72b",
    "zamba2_2_7b",
    "mixtral_8x22b",
    "granite_moe_3b_a800m",
    "xlstm_1_3b",
    "whisper_medium",
]

# CLI ids use dashes (``--arch internlm2-1.8b`` also accepted)
_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({"internlm2-1.8b": "internlm2_1_8b",
                 "phi3-medium-14b": "phi3_medium_14b",
                 "qwen3-8b": "qwen3_8b",
                 "granite-34b": "granite_34b",
                 "qwen2-vl-72b": "qwen2_vl_72b",
                 "zamba2-2.7b": "zamba2_2_7b",
                 "mixtral-8x22b": "mixtral_8x22b",
                 "granite-moe-3b-a800m": "granite_moe_3b_a800m",
                 "xlstm-1.3b": "xlstm_1_3b",
                 "whisper-medium": "whisper_medium"})


def get_config(arch: str) -> ModelConfig:
    arch = _ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS",
           "get_config", "all_configs"]
