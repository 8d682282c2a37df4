"""Parallelism across ranks: process groups (:mod:`.context`), the
logical-axis rules and shard placement (:mod:`.sharding`, imported from
its module: it needs ``repro_torch.quant``, which needs :mod:`.context`)
and GPipe stages (:mod:`.pipeline`)."""
from .context import (COLLECTIVES, TPGroup, rank_device, spawn, tp_context,
                      tp_group)

__all__ = ["COLLECTIVES", "TPGroup", "rank_device", "spawn", "tp_context",
           "tp_group"]
