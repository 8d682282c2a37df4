from .engine import DiffusionEngine, DiffusionStats, ImageRequest
from .sampler import DEFAULT_SCHEDULE, DiffusionSchedule, guided_eps, sample

__all__ = ["DiffusionEngine", "DiffusionStats", "ImageRequest",
           "DEFAULT_SCHEDULE", "DiffusionSchedule", "guided_eps", "sample"]
