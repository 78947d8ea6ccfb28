from repro_torch.configs.base import (
    ARCH_IDS,
    SHAPES,
    InputShape,
    ModelConfig,
    all_configs,
    canonical,
    get,
    reduce_config,
    shape_applicable,
)

__all__ = [
    "ARCH_IDS",
    "SHAPES",
    "InputShape",
    "ModelConfig",
    "all_configs",
    "canonical",
    "get",
    "reduce_config",
    "shape_applicable",
]
