"""Paged KV-cache bookkeeping: block allocator + per-slot block tables
(port of ``repro/serving/paged_cache.py``; numpy only, as there).

The device side (``models/attention.py::init_paged_kv_cache``) holds
fixed-size KV block pools shared by every sequence; this module is the
host side that decides which physical block each logical block of each
sequence lives in:

  * :class:`BlockAllocator` — a free-list allocator with refcounts over
    ``num_blocks`` fixed-size blocks.  Block 0 is reserved as the *null
    block*: never allocated, all positions empty-sentinel, so zeroed
    block-table entries (unallocated logical blocks) read as fully
    masked in the kernel.  Pure host state, so its invariants (no
    double-allocation, free-list conservation, refcounts zero at drain)
    are property-tested directly in tests/test_serving.py.
  * :class:`PagedKVCache` — per-engine container pairing the allocator
    with the numpy block tables and the device pool tree.  ``ensure``
    grows a slot to cover ``n_tokens`` positions (atomic: raises
    :class:`PoolExhausted` *before* allocating anything when the pool
    cannot cover the request, so a failed grow never leaks blocks),
    ``release`` frees a slot's blocks back to the pool.

Decode is memory-capacity bound, so this layer — not the MACs — governs
deliverable throughput at serving scale: pads and short prompts no
longer consume ``max_len`` rings, and freed blocks recirculate to queued
requests every engine step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class PoolExhausted(RuntimeError):
    """The block pool cannot cover an allocation request (the engine
    reacts by preempting a sequence or deferring admission)."""


class BlockAllocator:
    """Free-list allocator with refcounts over fixed-size KV blocks.

    Block ids are ``1..num_blocks-1``; block 0 is the reserved null
    block and is never handed out.  ``alloc`` pops from the free list
    and sets the refcount to 1; ``free`` decrements and returns the
    block to the free list at zero.  Refcounts > 1 (``retain``) support
    future copy-on-write sharing; the serving engine today uses
    exclusive blocks.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block past "
                             "the reserved null block 0")
        if block_size < 1:
            raise ValueError("block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free list: low block ids are handed out first
        self._free = list(range(num_blocks - 1, 0, -1))
        self._ref = np.zeros(num_blocks, np.int32)

    # -- capacity ------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.num_blocks - 1 - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` positions."""
        return -(-n_tokens // self.block_size)

    # -- alloc/free ----------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"all {self.num_blocks - 1} KV blocks in use")
        b = self._free.pop()
        if self._ref[b] != 0:
            raise AssertionError(f"block {b} on free list with refcount "
                                 f"{self._ref[b]}")
        self._ref[b] = 1
        return b

    def retain(self, block: int) -> None:
        if block <= 0 or self._ref[block] <= 0:
            raise ValueError(f"retain of unallocated block {block}")
        self._ref[block] += 1

    def free(self, block: int) -> None:
        if block <= 0 or block >= self.num_blocks:
            raise ValueError(f"free of invalid block id {block}")
        if self._ref[block] <= 0:
            raise ValueError(f"double free of block {block}")
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(block)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    # -- invariants (property tests call this after every op) ----------
    def check(self) -> None:
        free = self._free
        assert 0 not in free, "null block leaked onto the free list"
        assert len(set(free)) == len(free), "duplicate free-list entries"
        for b in free:
            assert self._ref[b] == 0, f"free block {b} has refcount"
        live = int(np.count_nonzero(self._ref[1:]))
        assert live + len(free) == self.num_blocks - 1, \
            "free-list conservation violated"
        assert self._ref[0] == 0


class PagedKVCache:
    """Host bookkeeping + device pools for one serving engine.

    ``tables`` is the numpy source of truth ([n_slots, max_blocks]
    int32, 0 = unallocated/null); the engine copies it to the device
    once per step, so the device never holds a stale copy.  ``cache`` is
    the per-layer list of pool dicts from ``Model.init_paged_cache``
    (int8 + scale side-tensors when ``kv_dtype == "int8"``).
    """

    def __init__(self, model, n_slots: int, max_len: int, block_size: int,
                 num_blocks: Optional[int] = None, kv_dtype=None):
        self.n_slots = n_slots
        self.block_size = block_size
        self.max_blocks = -(-max_len // block_size)     # table width
        if num_blocks is None:
            # default: every slot can hold a full-length sequence
            num_blocks = 1 + n_slots * self.max_blocks
        self.allocator = BlockAllocator(num_blocks, block_size)
        self.tables = np.zeros((n_slots, self.max_blocks), np.int32)
        self.n_blocks_of = np.zeros(n_slots, np.int32)
        self.cache = model.init_paged_cache(
            n_slots, num_blocks, block_size, self.max_blocks,
            kv_dtype=kv_dtype)

    @property
    def capacity_tokens(self) -> int:
        """Positions one sequence can hold (block-granular bound)."""
        return self.max_blocks * self.block_size

    def can_fit(self, n_tokens: int) -> bool:
        return self.allocator.n_free >= self.allocator.blocks_for(n_tokens)

    def ensure(self, slot: int, n_tokens: int) -> list[int]:
        """Grow ``slot`` to cover ``n_tokens`` positions; returns the
        newly allocated physical block ids (for the engine's
        stale-position scrub).  Atomic: raises :class:`PoolExhausted`
        before allocating anything if the pool cannot cover it."""
        need = self.allocator.blocks_for(n_tokens)
        if need > self.max_blocks:
            raise PoolExhausted(
                f"{n_tokens} tokens need {need} blocks but the table "
                f"holds {self.max_blocks}")
        have = int(self.n_blocks_of[slot])
        if need - have > self.allocator.n_free:
            raise PoolExhausted(
                f"slot {slot} needs {need - have} more block(s), "
                f"{self.allocator.n_free} free")
        new = []
        while self.n_blocks_of[slot] < need:
            b = self.allocator.alloc()
            self.tables[slot, self.n_blocks_of[slot]] = b
            self.n_blocks_of[slot] += 1
            new.append(b)
        return new

    def release(self, slot: int) -> list[int]:
        """Free every block of ``slot``; returns the freed ids."""
        n = int(self.n_blocks_of[slot])
        freed = [int(b) for b in self.tables[slot, :n]]
        for b in freed:
            self.allocator.free(b)
        self.tables[slot, :] = 0
        self.n_blocks_of[slot] = 0
        return freed

    def utilization(self) -> float:
        """Fraction of the allocatable pool currently in use."""
        return self.allocator.n_used / (self.allocator.num_blocks - 1)

    def fragmentation(self, used_tokens: int) -> float:
        """Internal fragmentation of the allocated blocks: the fraction
        of allocated positions holding no KV entry (last-block padding
        plus positions pre-allocated a step ahead of their write).
        ``used_tokens`` is the engine's count of written positions —
        the allocator tracks blocks, not entries."""
        allocated = int(self.n_blocks_of.sum()) * self.block_size
        if allocated == 0:
            return 0.0
        return 1.0 - min(used_tokens, allocated) / allocated
