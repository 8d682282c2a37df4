from .base import ModelConfig
from .registry import ARCH_IDS, get_config
from .shapes import reduced_config

__all__ = ["ModelConfig", "ARCH_IDS", "get_config", "reduced_config"]
