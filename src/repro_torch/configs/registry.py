"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import ModelConfig, SHAPES, ShapeConfig, reduced, shape_applicable  # noqa: F401

_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "yi-34b": "yi_34b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2-72b": "qwen2_72b",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-26b": "internvl2_26b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in _MODULES}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
