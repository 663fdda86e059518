"""Architecture registry: --arch <id> -> ModelConfig. The port holds the
configurations its model code covers."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig, reduced_for_smoke  # noqa: F401

_MODULES: Dict[str, str] = {
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0p6b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, **overrides) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    cfg = importlib.import_module(_MODULES[arch]).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
