from .adamw import (AdamWConfig, cosine_schedule, decay_mask, global_norm,
                    init, update)
from .compress import int8_compress_grads, int8_decompress_grads

__all__ = ["AdamWConfig", "cosine_schedule", "decay_mask", "global_norm",
           "init", "update", "int8_compress_grads", "int8_decompress_grads"]
