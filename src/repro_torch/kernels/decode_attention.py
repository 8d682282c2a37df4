"""Flash-decode kernels (port of ``repro/kernels/decode_attention.py``).

Three walks share one CUDA body in ``csrc/decode_attention.cu``; its
note says what bounds them and how the design follows the reference
(int8 K/V dequantized in the kernel, position masks, online softmax,
the all-masked-step skip).  In short: a walk is bound by round trips to
device memory, not by bytes, so the body reads a range's positions once
into a bitmask and a list of kept steps, streams the kept steps' K/V
rows and scales through a ring of ``cp.async`` stages in shared memory,
and spreads one walk over a thread-block cluster whose ranks merge their
softmax states through distributed shared memory.  The launch plan
(cluster size, shared-memory bytes) is decided here, by
:func:`walk_plan`: the cluster size from S and D only (the stage count
is the kernel's constant), so the ring, paged and split walks over one
range make the same sums in the same order.
Each wrapper takes its plain version for CPU tensors; for CUDA tensors
it launches its kernel or raises, and counts the launch.

* :func:`decode_attention` — the ring cache (``decode_attention``).
* :func:`decode_attention_paged` — the paged cache: KV blocks of shared
  pools read through per-row block tables (``decode_attention_paged``).
* :func:`decode_attention_partial` and :func:`decode_attention_combine`
  — the split-KV walk emitting raw ``(o, m, l)`` per slice, and the
  renormalization (``decode_attention_splitkv``, ``_combine_kernel``).

q:   [B, KH, G, D]    (GQA groups factored)
k,v: [B, S, KH, D]    (bf16/f32, or int8 with [B, S, KH] f32 scales)
pos: [B, S] int32     (slot positions; 2**30 = empty)
q_pos: [B] int32      (current decode position)
pools: k/v [NB, bs, KH, D], pos [NB, bs], scales [NB, bs, KH];
block_tables [B, nb] int32, 0 = the all-empty null block
out: [B, KH, G, D]    (q's dtype)
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from . import ref
from ._launch import (DTYPE_CODE, F, I, P, bind, check, on_cpu, ptr,
                      require, stream)

NEG_INF = ref.NEG_INF
EMPTY_SLOT = 2 ** 30
# query rows per kv head the kernel holds (its MAXG)
MAX_GROUP = 16
# a split's length is a multiple of the kernel's step (64 int8 slots)
SPLIT_STEP = 64
# dynamic shared memory a block may use on sm_90 (227 KB)
MAX_SMEM = 232448
# cluster sizes the plan picks from (8 is the portable maximum)
CLUSTERS = (1, 2, 4, 8)
# steps in flight in the shared-memory ring (the kernel's NST)
STAGES = 4
_NT = 256  # threads per block

_LIB = "decode_attention"


# ---------------------------------------------------------------------------
# Launch plan
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WalkPlan:
    cluster: int   # blocks of a cluster, each walking a share of the steps
    smem: int      # dynamic shared-memory bytes of a block
    # a paged walk too long for one block: the number of slices it is
    # walked in, as the split walk's partials merged by the combine
    splits: int = 1


def cluster_for(S: int, D: int) -> int:
    """Blocks per walk: the fewest that leave each rank at most 4 steps
    of 64 slots at D 256 (a step's work scales with D), up to 8.  Chosen
    by timing every size on the card: at 1024 slots D 256 (gemma-2b)
    takes 4, D 128 (qwen2-moe, 16 KV heads) 2; kernel 9 at 8192 takes 8
    (``chip_smoke.py``'s forced-cluster ``[times]`` lines).  A function of S and D alone,
    never of B, KH, G, the split count or the walk, so every walk over
    one range partitions it alike (the bitwise pins)."""
    work = -(-S // SPLIT_STEP) * D / 256
    c = 1
    while c < CLUSTERS[-1] and work > 4 * c:
        c *= 2
    return c


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(kv_bytes: int, D: int, G: int, range_slots: int,
               table_entries: int = 0) -> int:
    """Dynamic shared memory of one block, as the kernel lays it out
    (``layout`` in ``csrc/decode_attention.cu``, whose
    ``decode_attention_smem_bytes`` a card test holds this against):
    the stage ring (K rows
    padded by 16 bytes, V rows, both scales), reused for the p . v
    slices' sums; q in f32; the scores and probabilities of a step; the
    rows' rescale, max and sum; the range's visibility bitmask and kept
    steps; the paged walk's table row; the count of kept steps."""
    BS = 64 // kv_bytes
    maxg = 1 << max(G - 1, 0).bit_length()
    row = _align16(D * kv_bytes)
    stage = BS * (2 * row + 16) + 2 * BS * 4
    dw = min(D, 4)
    part = min(BS, _NT // (D // dw)) * G * D * 4
    return (_align16(max(STAGES * stage, part)) + _align16(G * D * 4)
            + _align16(G * BS * 4) + _align16(BS * maxg * 4)
            + _align16(G * 4) + _align16(2 * G * 4)
            + _align16(-(-range_slots // 32) * 4)
            + _align16(-(-range_slots // BS) * 4)
            + _align16(table_entries * 4) + 16)


_FORCED: dict = {}


@contextlib.contextmanager
def forced_plan(cluster: int):
    """Force the plan's cluster size for the walks launched inside the
    block (tests and timings of each size)."""
    if cluster not in CLUSTERS:
        raise ValueError(f"cluster must be one of {CLUSTERS}")
    saved = dict(_FORCED)
    _FORCED["cluster"] = cluster
    try:
        yield
    finally:
        _FORCED.clear()
        _FORCED.update(saved)


@contextlib.contextmanager
def walk_as_ranks(p: int):
    """Inside the block an unsharded ring or MLA latent cache that a
    tensor-parallel group of ``p`` would cut by sequence
    (``parallel.sharding.leaf_seq_slots``) is walked at a decode step as
    its p ranks walk their slots (``quant.tp.seq_cut``): the ring in p s
    splits of one kernel-9 launch merged by kernel 10 (s the splits of a
    rank's slots), the latent in p chunks merged as the ranks merge
    (``models.mla``).  The unsharded run that such a sharded decode
    reproduces bit for bit."""
    if p < 1:
        raise ValueError("p must be positive")
    saved = dict(_FORCED)
    _FORCED["ranks"] = p
    try:
        yield
    finally:
        _FORCED.clear()
        _FORCED.update(saved)


def walked_ranks() -> int | None:
    """The p of the innermost :func:`walk_as_ranks`, else None."""
    return _FORCED.get("ranks")


def walk_plan(S: int, D: int, G: int, kv_dtype: torch.dtype, mode: str,
              n_splits: int = 1, bs: int | None = None,
              cluster_slots: int | None = None) -> WalkPlan:
    """The launch plan of one walk: ``mode`` is "ring", "paged" (``bs``
    slots a pool block, S = nb * bs) or "split" (``n_splits`` slices).
    The cluster size depends on S and D only (``cluster_slots`` in place
    of S: a tensor-parallel rank's slots of a longer ring, planned as
    the whole ring's walk); the bytes also on the cache dtype, G and the
    range a block reads.  A paged walk whose
    bitmask, step list and table row outgrow a block (above about 189
    thousand int8 slots at D 256, G 8) is planned in the fewest slices
    of :func:`split_len` slots that fit one (``splits``); a ring or split
    walk that does not fit raises."""
    kv_bytes = torch.empty((), dtype=kv_dtype).element_size()
    cluster = _FORCED.get("cluster", cluster_for(cluster_slots or S, D))
    rng = split_len(S, n_splits) if mode == "split" else S
    smem = smem_bytes(kv_bytes, D, G, rng,
                      S // bs if mode == "paged" else 0)
    if smem <= MAX_SMEM:
        return WalkPlan(cluster, smem)
    if mode == "paged":
        ns = 2
        while ns < S and smem_bytes(kv_bytes, D, G,
                                    split_len(S, ns)) > MAX_SMEM:
            ns += 1
        return WalkPlan(cluster, smem_bytes(kv_bytes, D, G,
                                            split_len(S, ns)), ns)
    raise ValueError(f"decode attention: a walk over {rng} slots needs "
                     f"{smem} bytes of shared memory, over {MAX_SMEM}")


def _check_walk(q: torch.Tensor, k, v, pos, q_pos, k_scale, v_scale,
                window, kv_shape, pos_shape) -> int:
    """Checks shared by the walks (``kv_shape`` of K and V, ``pos_shape``
    of the positions; the scales are ``kv_shape[:3]``); returns the C
    code of the KV dtype."""
    B, KH, G, D = q.shape
    require(q, "q", (torch.float32, torch.bfloat16))
    if k_scale is not None:
        kv_dtype = torch.int8
        require(k_scale, "k_scale", torch.float32, kv_shape[:3])
        require(v_scale, "v_scale", torch.float32, kv_shape[:3])
    else:
        kv_dtype = q.dtype
    require(k, "k", kv_dtype, kv_shape)
    require(v, "v", kv_dtype, kv_shape)
    require(pos, "pos", torch.int32, pos_shape)
    require(q_pos, "q_pos", torch.int32, (B,))
    if D > 256 or 256 % D or G > MAX_GROUP:
        raise ValueError(f"decode attention kernels take 256 % D == 0 and "
                         f"G <= {MAX_GROUP}; got D={D}, G={G}")
    if window is not None and window <= 0:
        raise ValueError("window must be positive")
    return 0 if k_scale is not None else DTYPE_CODE[q.dtype]


def _check_rows(n: int, what: str) -> None:
    if n >= 2 ** 31:
        raise ValueError(f"{what}: {n} cache rows exceed the kernel's "
                         f"32-bit row index")


# ---------------------------------------------------------------------------
# Ring walk (kernel 5)
# ---------------------------------------------------------------------------
def decode_attention_plain(q, k, v, pos, q_pos, k_scale=None, v_scale=None,
                           window=None):
    return ref.decode_attention_ref(q, k, v, pos, q_pos, window=window,
                                    k_scale=k_scale, v_scale=v_scale)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, q_pos: torch.Tensor,
                     k_scale: torch.Tensor | None = None,
                     v_scale: torch.Tensor | None = None,
                     window: int | None = None) -> torch.Tensor:
    """One-token attention of q over the ring cache in one walk.

    ``k_scale``/``v_scale`` turn on the int8-KV path (K/V must then be
    int8).  ``window`` masks slots at or before ``q_pos - window``.
    """
    if on_cpu(q, k, v, pos, q_pos, k_scale, v_scale):
        return decode_attention_plain(q, k, v, pos, q_pos, k_scale, v_scale,
                                      window)
    B, KH, G, D = q.shape
    S = k.shape[1]
    kv_kind = _check_walk(q, k, v, pos, q_pos, k_scale, v_scale, window,
                          (B, S, KH, D), (B, S))
    _check_rows(B * S, "decode_attention")
    plan = walk_plan(S, D, G, k.dtype, "ring")
    out = torch.empty_like(q)
    fn = bind(_LIB, "decode_attention_launch",
              [P, I, P, P, I, P, P, P, P, P, I, I, I, I, I, I, F, I, I, P])
    check(_LIB, fn(ptr(q), DTYPE_CODE[q.dtype], ptr(k), ptr(v), kv_kind,
                   ptr(pos), ptr(q_pos), ptr(k_scale), ptr(v_scale),
                   ptr(out), B, S, KH, G, D, window or 0,
                   1.0 / math.sqrt(D), plan.cluster, plan.smem, stream(q)),
          "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Paged walk (kernel 11)
# ---------------------------------------------------------------------------
def decode_attention_paged_plain(q, k_pages, v_pages, pos_pages,
                                 block_tables, q_pos, k_scale_pages=None,
                                 v_scale_pages=None, window=None):
    return ref.decode_attention_paged_ref(
        q, k_pages, v_pages, pos_pages, block_tables, q_pos, window=window,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages)


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, pos_pages: torch.Tensor,
                           block_tables: torch.Tensor, q_pos: torch.Tensor,
                           k_scale_pages: torch.Tensor | None = None,
                           v_scale_pages: torch.Tensor | None = None,
                           window: int | None = None) -> torch.Tensor:
    """One-token attention over the paged cache: slot ``j`` of row ``b``
    is slot ``j % bs`` of pool block ``block_tables[b, j // bs]``.

    Block 0 is the null block (all positions empty), so zero table
    entries read as masked.  On the card a table entry outside
    ``[0, NB)`` is read as the null block, never outside the pools.
    Bitwise equal to :func:`decode_attention` on the equivalent ring
    layout (one body, the same skip decisions).  A walk too long for one
    block (``walk_plan``'s ``splits``) runs in slices instead: the split
    walk and the combine, within summation order of the single walk.
    """
    if on_cpu(q, k_pages, v_pages, pos_pages, block_tables, q_pos,
              k_scale_pages, v_scale_pages):
        return decode_attention_paged_plain(
            q, k_pages, v_pages, pos_pages, block_tables, q_pos,
            k_scale_pages, v_scale_pages, window)
    B, KH, G, D = q.shape
    if k_pages.dim() != 4:
        raise ValueError(f"k_pages: expected [NB, bs, KH, D], got shape "
                         f"{tuple(k_pages.shape)}")
    NB, bs = k_pages.shape[:2]
    kv_kind = _check_walk(q, k_pages, v_pages, pos_pages, q_pos,
                          k_scale_pages, v_scale_pages, window,
                          (NB, bs, KH, D), (NB, bs))
    require(block_tables, "block_tables", torch.int32)
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables: expected [{B}, nb], got shape "
                         f"{tuple(block_tables.shape)}")
    nb = block_tables.shape[1]
    _check_rows(NB * bs, "decode_attention_paged")
    _check_rows(nb * bs, "decode_attention_paged")
    plan = walk_plan(nb * bs, D, G, k_pages.dtype, "paged", bs=bs)
    if plan.splits > 1:
        return _paged_in_slices(q, k_pages, v_pages, pos_pages,
                                block_tables, q_pos, k_scale_pages,
                                v_scale_pages, window, plan.splits)
    out = torch.empty_like(q)
    fn = bind(_LIB, "decode_attention_paged_launch",
              [P, I, P, P, I, P, P, P, P, P, P, I, I, I, I, I, I, I, I, F,
               I, I, P])
    check(_LIB, fn(ptr(q), DTYPE_CODE[q.dtype], ptr(k_pages), ptr(v_pages),
                   kv_kind, ptr(pos_pages), ptr(block_tables), ptr(q_pos),
                   ptr(k_scale_pages), ptr(v_scale_pages), ptr(out), B, NB,
                   bs, nb, KH, G, D, window or 0, 1.0 / math.sqrt(D),
                   plan.cluster, plan.smem, stream(q)),
          "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0


def _paged_in_slices(q, k_pages, v_pages, pos_pages, block_tables, q_pos,
                     k_scale_pages, v_scale_pages, window, n_splits):
    """A paged walk too long for one block: the rows' pool blocks are
    gathered in table order (an entry outside the pool reads as the null
    block, as in the kernel) into the ring layout, walked in ``n_splits``
    slices of whole 64-slot steps by the split walk and merged by the
    combine: two launches, and the ring layout's copy of the rows'
    cache.  Differs from the single walk by summation order only."""
    B, nb = block_tables.shape
    NB, bs = k_pages.shape[:2]
    tab = block_tables.long()
    tab = torch.where((tab >= 0) & (tab < NB), tab, torch.zeros_like(tab))

    def ring(pages):
        if pages is None:
            return None
        return pages[tab].reshape(B, nb * bs, *pages.shape[2:])
    o, m, l = decode_attention_partial(
        q, ring(k_pages), ring(v_pages), ring(pos_pages), q_pos,
        ring(k_scale_pages), ring(v_scale_pages), window, n_splits)
    return decode_attention_combine(o, m, l, q.dtype)


# ---------------------------------------------------------------------------
# Split walk (kernel 9) and combine (kernel 10)
# ---------------------------------------------------------------------------
def split_len(S: int, n_splits: int) -> int:
    """Slots per split: the walk's ``ceil(S / 64)`` steps shared out
    evenly, so every boundary falls on a step of the single walk."""
    steps = -(-S // SPLIT_STEP)
    return -(-steps // n_splits) * SPLIT_STEP


def decode_attention_partial_plain(q, k, v, pos, q_pos, k_scale=None,
                                   v_scale=None, window=None, n_splits=2):
    return ref.decode_attention_partial_ref(
        q, k, v, pos, q_pos, n_splits, split_len(k.shape[1], n_splits),
        window=window, k_scale=k_scale, v_scale=v_scale)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, pos: torch.Tensor,
                             q_pos: torch.Tensor,
                             k_scale: torch.Tensor | None = None,
                             v_scale: torch.Tensor | None = None,
                             window: int | None = None, n_splits: int = 2,
                             cluster_slots: int | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The ring walk cut into ``n_splits`` slices of :func:`split_len`
    slots, each emitting its raw online-softmax state: o f32
    [B, KH, NS, G, D] (not divided by l), m and l f32 [B, KH, NS, G, 1].

    The all-empty-row exception is decided over the whole row; a slice
    with no visible slot in a row that has some emits m = -1e30, l = 0,
    o = 0.  ``cluster_slots``: k holds a tensor-parallel rank's slots
    of a ring of that many, and the launch takes the whole ring's
    cluster size (:func:`cluster_for`), so each split sums as the same
    split of the unsharded walk does (the plain version has no
    cluster).
    """
    if n_splits < 1:
        raise ValueError("n_splits must be positive")
    if on_cpu(q, k, v, pos, q_pos, k_scale, v_scale):
        return decode_attention_partial_plain(q, k, v, pos, q_pos, k_scale,
                                              v_scale, window, n_splits)
    B, KH, G, D = q.shape
    S = k.shape[1]
    kv_kind = _check_walk(q, k, v, pos, q_pos, k_scale, v_scale, window,
                          (B, S, KH, D), (B, S))
    _check_rows(B * S, "decode_attention_partial")
    o = torch.empty((B, KH, n_splits, G, D), dtype=torch.float32,
                    device=q.device)
    m = torch.empty((B, KH, n_splits, G, 1), dtype=torch.float32,
                    device=q.device)
    l = torch.empty_like(m)
    plan = walk_plan(S, D, G, k.dtype, "split", n_splits,
                     cluster_slots=cluster_slots)
    fn = bind(_LIB, "decode_attention_partial_launch",
              [P, I, P, P, I, P, P, P, P, P, P, P, I, I, I, I, I, I, F, I,
               I, I, I, P])
    check(_LIB, fn(ptr(q), DTYPE_CODE[q.dtype], ptr(k), ptr(v), kv_kind,
                   ptr(pos), ptr(q_pos), ptr(k_scale), ptr(v_scale), ptr(o),
                   ptr(m), ptr(l), B, S, KH, G, D, window or 0,
                   1.0 / math.sqrt(D), n_splits, split_len(S, n_splits),
                   plan.cluster, plan.smem, stream(q)),
          "decode_attention_partial")
    decode_attention_partial.launches += 1
    return o, m, l


decode_attention_partial.launches = 0


def decode_attention_combine_plain(o, m, l, out_dtype):
    return ref.combine_partials_ref(o, m, l).to(out_dtype)


def decode_attention_combine(o: torch.Tensor, m: torch.Tensor,
                             l: torch.Tensor,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """Renormalize the split states against their common max:
    ``sum_s o_s w_s / max(sum_s l_s w_s, 1e-30)`` with
    ``w_s = exp(m_s - max_s m_s)``, summed in ascending s, -> [B, KH, G,
    D] in ``out_dtype``; one launch, a block per (row, kv head, query
    row) and slice of D."""
    if on_cpu(o, m, l):
        return decode_attention_combine_plain(o, m, l, out_dtype)
    if o.dim() != 5:
        raise ValueError(f"o: expected [B, KH, NS, G, D], got shape "
                         f"{tuple(o.shape)}")
    B, KH, NS, G, D = o.shape
    require(o, "o", torch.float32)
    require(m, "m", torch.float32, (B, KH, NS, G, 1))
    require(l, "l", torch.float32, (B, KH, NS, G, 1))
    if out_dtype not in DTYPE_CODE:
        raise TypeError(f"out_dtype {out_dtype} not in {tuple(DTYPE_CODE)}")
    out = torch.empty((B, KH, G, D), dtype=out_dtype, device=o.device)
    fn = bind(_LIB, "decode_attention_combine_launch",
              [P, P, P, P, I, I, I, I, I, P])
    check(_LIB, fn(ptr(o), ptr(m), ptr(l), ptr(out), DTYPE_CODE[out_dtype],
                   B * KH, NS, G, D, stream(o)),
          "decode_attention_combine")
    decode_attention_combine.launches += 1
    return out


decode_attention_combine.launches = 0


def max_active_clusters(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                        mode: str, S: int, KH: int, G: int, D: int,
                        n_splits: int = 1, bs: int | None = None) -> int:
    """How many clusters of this walk's plan the card holds at once
    (``cudaOccupancyMaxActiveClusters``); needs a card."""
    import ctypes
    plan = walk_plan(S, D, G, kv_dtype, mode, n_splits, bs)
    kv_kind = 0 if kv_dtype == torch.int8 else DTYPE_CODE[kv_dtype]
    out = ctypes.c_int(0)
    fn = bind(_LIB, "decode_attention_max_clusters",
              [I, I, I, I, I, I, I, I, I, I, I, P])
    modes = {"ring": 0, "paged": 1, "split": 2}
    check(_LIB, fn(DTYPE_CODE[q_dtype], kv_kind, modes[mode], S, KH, G, D,
                   bs or 0, split_len(S, n_splits) if mode == "split" else 0,
                   plan.cluster, plan.smem,
                   ctypes.cast(ctypes.pointer(out), ctypes.c_void_p)),
          "decode_attention_max_clusters")
    return out.value


def kernel_smem_bytes(kv_dtype: torch.dtype, D: int, G: int,
                      range_slots: int, table_entries: int = 0) -> int:
    """The kernel's own count of :func:`smem_bytes`
    (``decode_attention_smem_bytes``); needs the built library."""
    kv_bytes = torch.empty((), dtype=kv_dtype).element_size()
    fn = bind(_LIB, "decode_attention_smem_bytes", [I, I, I, I, I])
    return fn(kv_bytes, D, G, range_slots, table_entries)
