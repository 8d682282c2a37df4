from .base import ModelConfig
from .dit import DiTConfig
from .registry import (ARCH_IDS, DIT_ARCH_IDS, all_dit_configs, get_config,
                       get_dit_config)
from .shapes import (ASSIGNED_SHAPES, PERF_SHAPES, SHAPES, ShapeCell,
                     cell_applicable, input_specs, reduced_config)

__all__ = ["ModelConfig", "DiTConfig", "ARCH_IDS", "DIT_ARCH_IDS",
           "all_dit_configs", "get_config", "get_dit_config", "SHAPES",
           "ASSIGNED_SHAPES", "PERF_SHAPES", "ShapeCell", "cell_applicable",
           "input_specs", "reduced_config"]
