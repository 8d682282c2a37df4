"""Facts of one run of a model step: the kernel wrappers' launches and the
aten ops around them.

The reference's auditor traces a step into a jaxpr and reads its Pallas
calls and XLA ops (``repro/analysis/jaxpr_tools.py``).  The port runs
eagerly, so the facts come from running the step once under a
:class:`Recorder`:

* **launches** by launch counter (the keys of
  :data:`repro_torch.kernels.KERNELS`): on the card the counters'
  deltas; on the CPU, where a wrapper takes its plain version and counts
  nothing, its calls (``kernels._launch.on_cpu`` reports each to the
  recorder), each of which launches once on the card;
* **ops**: every aten op the step dispatches, taken with a
  ``TorchDispatchMode``, with its scope — ``"kernel"`` inside a wrapper
  (on the card the wrappers' allocations; on the CPU their plain
  versions, which the passes do not hold against the contract),
  ``"collective"`` inside ``TPGroup``'s collectives, ``"outside"``
  elsewhere — and its tensors by identity, so a pass can follow one
  tensor from the op that made it to the ops that read it;
  each of ``TPGroup``'s collectives is one more op,
  ``"collective:<kind>"``, with its tensor (the group's ``observer``).

The ctypes launches never reach the dispatcher: on the card, an op in
scope ``"kernel"`` is an allocation or a view made by the wrapper.
"""
from __future__ import annotations

import dataclasses
import inspect
import sys
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import kernels
from repro_torch.kernels import _launch
from repro_torch.parallel.context import TPGroup

_ANALYSIS_DIR = __file__.rsplit("/", 1)[0]
_TORCH_DIR = torch.__file__.rsplit("/", 1)[0]


@dataclasses.dataclass(frozen=True)
class TensorFact:
    ref: int                 # the tensor's identity within the record
    dtype: torch.dtype
    shape: tuple


@dataclasses.dataclass(frozen=True)
class OpFact:
    op: str          # aten op ("mm", "_to_copy") or "collective:<kind>"
    scope: str               # "outside" | "kernel" | "collective"
    kernel: str | None       # the innermost wrapper's counter, in "kernel"
    inputs: tuple
    outputs: tuple
    src: str                 # "file:line" of the caller outside torch


@dataclasses.dataclass
class StepRecord:
    launches: Counter = dataclasses.field(default_factory=Counter)
    ops: list = dataclasses.field(default_factory=list)


class _OpMode(TorchDispatchMode):
    def __init__(self, recorder: "Recorder"):
        super().__init__()
        self.recorder = recorder

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.recorder._on_op(func, (args, kwargs), out)
        return out


class Recorder:
    """Record one step: ``with Recorder(group) as rec: step()``, then read
    ``rec.record``.  ``group`` (a ``TPGroup``) has its collectives
    recorded.  The launch counters are read, never reset, so launches
    outside the block do not count."""

    def __init__(self, group: TPGroup | None = None):
        self.group = group
        self.record = StepRecord()
        self._kernel_codes = {inspect.unwrap(fn).__code__: name
                              for name, fn in kernels.KERNELS.items()}
        self._collective_codes = {TPGroup._all_reduce.__code__,
                                  TPGroup.all_gather.__code__}
        self._serials: dict[int, tuple] = {}
        self._mode = _OpMode(self)

    # -- hooks ---------------------------------------------------------
    def _fact(self, t: torch.Tensor) -> TensorFact:
        entry = self._serials.get(id(t))
        if entry is None or entry[0]() is not t:
            entry = (weakref.ref(t), len(self._serials) + 1)
            self._serials[id(t)] = entry
        return TensorFact(entry[1], t.dtype, tuple(t.shape))

    def _scope(self) -> tuple[str, str | None, str]:
        """(scope, kernel, src) of the op being dispatched, from the
        Python frames: the innermost wrapper or collective, and the first
        frame outside torch and this package."""
        f = sys._getframe(3)
        src = None
        while f is not None:
            code = f.f_code
            name = self._kernel_codes.get(code)
            if name is not None:
                return "kernel", name, src or ""
            if code in self._collective_codes:
                return "collective", None, src or ""
            if src is None and not code.co_filename.startswith(
                    (_TORCH_DIR, _ANALYSIS_DIR)):
                src = f"{code.co_filename}:{f.f_lineno}"
            f = f.f_back
        return "outside", None, src or ""

    def _on_op(self, func, args, out) -> None:
        scope, kernel, src = self._scope()
        ins = tuple(self._fact(t) for t in tree_leaves(args)
                    if isinstance(t, torch.Tensor))
        outs = tuple(self._fact(t) for t in tree_leaves(out)
                     if isinstance(t, torch.Tensor))
        self.record.ops.append(OpFact(func.overloadpacket.__name__, scope,
                                      kernel, ins, outs, src))

    def _on_call(self, code) -> None:
        self.record.launches[self._kernel_codes.get(code,
                                                    code.co_name)] += 1

    def _on_collective(self, kind: str, t: torch.Tensor) -> None:
        self.record.ops.append(OpFact(f"collective:{kind}", "collective",
                                      None, (self._fact(t),), (), ""))

    # -- context -------------------------------------------------------
    def __enter__(self) -> "Recorder":
        if _launch.observer is not None:
            raise RuntimeError("a Recorder is already active")
        self._before = kernels.launch_counts()
        _launch.observer = self._on_call
        if self.group is not None:
            self.group.observer = self._on_collective
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        _launch.observer = None
        if self.group is not None:
            self.group.observer = None
        for name, n in kernels.launch_counts().items():
            if n - self._before[name]:
                self.record.launches[name] += n - self._before[name]
