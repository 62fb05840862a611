"""Architecture config registry of the port: its own copy of the JAX
package's pure dataclasses, so that the port imports nothing of it.

Every architecture has a module ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` and ``reduced()``; the registry maps arch ids (dashed names) to
those configs.
"""

from __future__ import annotations

from repro_torch.configs.base import (
    AttentionKind,
    Family,
    ModelConfig,
    MoEConfig,
    MLAConfig,
    SSMConfig,
    HybridConfig,
    EncDecConfig,
)
from repro_torch.configs.shapes import SHAPES, ShapeConfig, applicable_shapes

_ARCH_MODULES = {
    "starcoder2-3b": "starcoder2_3b",
    "granite-3-8b": "granite_3_8b",
    "deepseek-67b": "deepseek_67b",
    "mistral-large-123b": "mistral_large_123b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-base": "whisper_base",
    "pixtral-12b": "pixtral_12b",
    "mamba2-1.3b": "mamba2_13b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    if arch not in _ARCH_MODULES:
        raise KeyError(arch)
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.reduced()


__all__ = [
    "ARCH_IDS",
    "AttentionKind",
    "EncDecConfig",
    "Family",
    "HybridConfig",
    "MLAConfig",
    "ModelConfig",
    "MoEConfig",
    "SHAPES",
    "SSMConfig",
    "ShapeConfig",
    "applicable_shapes",
    "get_config",
    "reduced_config",
]
