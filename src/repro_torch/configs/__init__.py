"""Model and workload configurations: a copy of ``repro.configs``.

Pure Python and data, so ``get_config(name)`` and ``reduced(cfg)``
resolve exactly as in the JAX package.
"""
from .base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    MLAConfig,
    SSMConfig,
    XLSTMConfig,
    HybridConfig,
    SHAPES,
    ShapeConfig,
    reduced,
    shape_applicable,
)
from .registry import ARCH_NAMES, all_configs, get_config, get_shape  # noqa: F401
