"""Tensor-parallel process groups (port of ``repro/parallel/context.py``
and ``repro/launch/mesh.py``).

The reference runs one program over a device mesh and lets ``shard_map``
place the collectives.  Here every rank is a process of its own, holds
its shards of the weights, and calls the collectives itself through a
:class:`TPGroup`: the three the tensor-parallel pipeline needs
(``all_reduce`` MAX on f32 row maxima, ``all_reduce`` SUM on int32
accumulators, ``all_gather`` of the experts' outputs) and the engines'
``broadcast`` of rank 0's deadline verdicts, each counted by kind so
that a run can show how many it made.

:func:`tp_context` makes a group current for the enclosed scope, as the
reference's ``sharding_context`` makes a mesh current; the quantized
layers read it with :func:`tp_group`, as ``quant/tp.py`` reads
``tp_mesh()``.  A group of size 1 needs no process group: its
collectives return their input (and still count), so the tensor-parallel
code runs with trivial shards.

:func:`spawn` starts the ranks (``spawn`` start method) and returns what
each rank's function returned.  The backend is the caller's choice:
``gloo`` when the ranks share one card or run on the CPU (a CUDA tensor's
collective then goes through host memory: transport, not compute),
``nccl`` when each rank has a card of its own.
"""
from __future__ import annotations

import contextlib
import datetime
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

COLLECTIVES = ("max", "sum", "gather", "bcast")
BACKENDS = ("gloo", "nccl")


class TPGroup:
    """One rank's handle on a tensor-parallel group of ``size`` ranks.

    ``counts`` holds the collectives made so far by kind (``max``,
    ``sum``, ``gather``, ``bcast``); :meth:`agree` is the engines'
    end-of-run check and is not counted.  With ``backend="gloo"`` a CUDA
    tensor is copied to the host for the collective and back.
    ``observer(kind, tensor)``, when set, sees every counted collective's
    input (``analysis.record.Recorder`` sets it for one step)."""

    observer = None

    def __init__(self, rank: int = 0, size: int = 1,
                 backend: Optional[str] = None):
        if size > 1 and backend not in BACKENDS:
            raise ValueError(f"a group of {size} ranks needs a backend in "
                             f"{BACKENDS}, got {backend!r}")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a group of {size}")
        self.rank, self.size, self.backend = rank, size, backend
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    def reset_counts(self) -> None:
        self.counts = dict.fromkeys(COLLECTIVES, 0)

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _all_reduce(self, t: torch.Tensor, op, kind: str) -> torch.Tensor:
        self.counts[kind] += 1
        if self.observer is not None:
            self.observer(kind, t)
        if self.size == 1:
            return t
        if self._staged(t):
            host = t.cpu()
            dist.all_reduce(host, op)
            t.copy_(host)
        else:
            dist.all_reduce(t, op)
        return t

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks, in place (f32 row maxima)."""
        return self._all_reduce(t, dist.ReduceOp.MAX, "max")

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise sum over the ranks, in place (int32 partial
        accumulators: integer addition is exact in any order)."""
        return self._all_reduce(t, dist.ReduceOp.SUM, "sum")

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors (at least 1-d, the same shape on every
        rank) concatenated on the leading axis, in rank order.  Moved as
        raw bytes, so any dtype goes through any backend."""
        self.counts["gather"] += 1
        if self.observer is not None:
            self.observer("gather", t)
        if self.size == 1:
            return t
        raw = t.contiguous().view(torch.uint8)
        src = raw.cpu() if self._staged(t) else raw
        out = torch.empty((self.size * src.shape[0],) + src.shape[1:],
                          dtype=torch.uint8, device=src.device)
        dist.all_gather(list(out.chunk(self.size)), src)
        return out.to(t.device).view(t.dtype)

    def broadcast_flags(self, flags: list[bool]) -> list[bool]:
        """Rank 0's ``flags`` on every rank (the engines' deadline
        verdicts: rank 0's clock decides); the lists have one length on
        every rank."""
        self.counts["bcast"] += 1
        if self.size == 1:
            return list(flags)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))
        t = torch.tensor(flags, dtype=torch.uint8, device=dev)
        dist.broadcast(t, src=0)
        return [bool(f) for f in t.tolist()]

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier()

    def agree(self, digest: bytes) -> bool:
        """True if every rank passed the same ``digest`` (not counted)."""
        if self.size == 1:
            return True
        dev = (torch.device("cuda", torch.cuda.current_device())
               if self.backend == "nccl" else torch.device("cpu"))
        mine = torch.tensor(list(digest), dtype=torch.uint8, device=dev)
        outs = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(outs, mine)
        return all(torch.equal(o, mine) for o in outs)


_CURRENT: Optional[TPGroup] = None


@contextlib.contextmanager
def tp_context(group: Optional[TPGroup]):
    """Make ``group`` the current tensor-parallel group for the enclosed
    scope (None: no group)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = group
    try:
        yield group
    finally:
        _CURRENT = prev


def tp_group() -> Optional[TPGroup]:
    """The current group (see :func:`tp_context`), or None."""
    return _CURRENT


def rank_device(device, backend: str, rank: int) -> torch.device:
    """Where rank ``rank`` runs: the CPU if asked; with ``nccl`` card
    ``rank``; with ``gloo`` the one card that every rank shares.  Raises
    when no card is present and the CPU was not asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        index = (rank if backend == "nccl" else
                 torch.cuda.current_device() if dev.index is None
                 else dev.index)
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
    return dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, size, backend, port, args, results, timeout_s):
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(TPGroup(rank, size, backend), *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(fn: Callable, size: int, args: tuple = (), backend: str = "gloo",
          timeout_s: float = 1800.0) -> list:
    """Run ``fn(group, *args)`` on ``size`` ranks, each a process started
    with the ``spawn`` method and joined to a ``backend`` process group
    on this host; returns their results in rank order.

    ``fn`` must be importable (a module-level function) and its result
    picklable without tensors.  If a rank raises or dies, every other
    rank is terminated and this raises with the failing rank's
    traceback; so it does when ``timeout_s`` passes first."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, rank, size, backend, port, args, results,
                               timeout_s), name=f"tp-rank-{rank}")
             for rank in range(size)]
    for p in procs:
        p.start()
    done: dict[int, object] = {}
    failed: dict[int, str] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(done) + len(failed) < size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [(p.name, p.exitcode) for p in procs
                        if p.exitcode not in (None, 0)]
                if failed or dead:
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish within "
                                       f"{timeout_s} s")
                continue
            if ok:
                done[rank] = out
            else:
                # the others fail soon after, at their next collective;
                # gather their reports too for one error
                failed[rank] = out
        if failed:
            raise RuntimeError("".join(
                f"rank {r} failed:\n{tb}" for r, tb in sorted(failed.items())))
        if len(done) < size:
            raise RuntimeError(f"ranks exited without a result: "
                               f"{[(p.name, p.exitcode) for p in procs]}")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    bad = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks exited with {bad}")
    return [done[r] for r in range(size)]
