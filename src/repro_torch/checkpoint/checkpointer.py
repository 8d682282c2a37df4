"""Checkpointing with async writes and restore onto any device (port of
``repro/checkpoint/checkpointer.py``).

Design (stdlib + numpy):
  * ``save(step, tree)`` — each process writes its tensors into
    ``<dir>/step_<N>/host<rank>.npz`` plus a JSON manifest (tree
    structure, shapes, dtypes).  Writes go to a temp dir that is
    renamed into place; a ``COMMITTED`` marker makes partially written
    checkpoints invisible to restore (crash safety).
  * async mode — the tensors are copied to host memory before
    ``save`` returns and written on a daemon thread, so the train loop
    resumes at once; ``wait()`` joins the outstanding write (called
    before the next save and before exit).  The snapshot is a copy even
    of a CPU tensor (the reference's ``np.asarray`` can share nothing
    with an immutable JAX array; ``Tensor.numpy()`` shares memory, and
    an in-place optimizer step racing the writer would tear it).
  * ``restore(step, tree_like, device)`` — reads the tensors back into
    ``tree_like``'s structure and dtypes on the device the caller names:
    saved on the card, restored on the CPU, or the other way round (the
    reference's re-mesh restore places arrays by content, not layout).
  * ``latest_step()`` + retention (keep the last N) for restart after a
    failure.

A tree is a tensor, or a dict (flattened in sorted key order, as
``jax.tree.flatten`` does) or list of trees.  bf16 is stored as its
uint16 bits (npz has no bf16 codec).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.parallel.context import process_grid


def _flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, structure) of a tree; the structure is JSON-able."""
    if isinstance(tree, dict):
        leaves, spec = [], {}
        for k in sorted(tree):
            sub, spec[k] = _flatten(tree[k])
            leaves += sub
        return leaves, {"dict": spec}
    if isinstance(tree, (list, tuple)):
        leaves, spec = [], []
        for x in tree:
            sub, s = _flatten(x)
            leaves += sub
            spec.append(s)
        return leaves, {"list": spec}
    return [tree], None


def _unflatten(spec: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        if "dict" in s:
            return {k: build(v) for k, v in s["dict"].items()}
        return [build(v) for v in s["list"]]
    return build(spec)


def _host_copy(x: torch.Tensor) -> np.ndarray:
    """A copy of ``x`` in host memory as numpy (bf16 as uint16 bits)."""
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class Checkpointer:
    def __init__(self, directory: str | Path, keep: int = 3,
                 async_writes: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_writes = async_writes
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if (p / "COMMITTED").exists()]
        return max(steps) if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, wait: bool = False) -> None:
        self.wait()  # one outstanding async write at a time
        leaves, spec = _flatten(tree)
        host_leaves = [_host_copy(x) for x in leaves]
        manifest = {
            "step": step,
            "tree": spec,
            "n_leaves": len(leaves),
            "shapes": [list(x.shape) for x in host_leaves],
            "dtypes": [str(x.dtype) for x in leaves],
            "time": time.time(),
        }
        rank = process_grid()[0]

        def _write():
            tmp = self._step_dir(step).with_suffix(".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / f"host{rank}.npz",
                     **{f"leaf_{i}": x for i, x in enumerate(host_leaves)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self._step_dir(step)
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)
            (final / "COMMITTED").touch()
            self._gc()

        if self.async_writes and not wait:
            def _guarded():
                try:
                    _write()
                except Exception as e:   # re-raised by wait()
                    self._error = e
            self._thread = threading.Thread(target=_guarded, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        """Join the outstanding write; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
            if (p / "COMMITTED").exists())
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, step: int, tree_like: Any,
                device: Optional[str | torch.device] = None) -> Any:
        """Restore ``step`` into the structure and dtypes of
        ``tree_like``, each tensor on ``device`` (default: the device of
        its counterpart in ``tree_like``)."""
        d = self._step_dir(step)
        if not (d / "COMMITTED").exists():
            raise FileNotFoundError(f"no committed checkpoint at {d}")
        leaves, spec = _flatten(tree_like)
        restored = []
        with np.load(d / f"host{process_grid()[0]}.npz") as data:
            for i, ref in enumerate(leaves):
                r = np.array(data[f"leaf_{i}"])     # writable, owned
                if ref.dtype == torch.bfloat16 and r.dtype == np.uint16:
                    t = torch.from_numpy(r.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(r).to(ref.dtype)
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: saved shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(ref.shape)}")
                restored.append(t.to(ref.device if device is None
                                     else device))
        return _unflatten(spec, restored)

    def restore_latest(self, tree_like: Any,
                       device: Optional[str | torch.device] = None
                       ) -> tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, tree_like
        return step, self.restore(step, tree_like, device)
