from .model import Block, Model, block_apply

__all__ = ["Block", "Model", "block_apply"]
