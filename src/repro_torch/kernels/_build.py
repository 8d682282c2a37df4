"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface under ``build/repro_torch/`` at the
root of the checkout, once, at first use; ``ctypes`` loads it.  All
sources compile in parallel (one ``nvcc`` process each).  A library is
rebuilt when its source is newer.  There is deliberately no
``--use_fast_math``: row quantization must divide in IEEE arithmetic to
match the plain version bit for bit.
"""
from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent.parent / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# per-source build record: {"seconds": float, "log": str, "cached": bool}
BUILD_LOG: dict[str, dict] = {}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = pathlib.Path(CUDA_HOME) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    return BUILD_DIR / f"lib{src.stem}.so"


def _stale(src: pathlib.Path) -> bool:
    lib = _lib_path(src)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all() -> dict[str, dict]:
    """Compile every stale source, all ``nvcc`` processes at once.

    Returns the per-source build record (seconds, compiler log).  Raises
    with the compiler's output if any source fails.
    """
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for src in sources():
            if not _stale(src):
                BUILD_LOG.setdefault(src.stem, {"seconds": 0.0, "log": "",
                                                "cached": True})
                continue
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, time.perf_counter())
        failures = []
        for src, (proc, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[src.stem] = {"seconds": time.perf_counter() - t0,
                                   "log": log, "cached": False}
            if proc.returncode != 0:
                os.unlink(tmp)
                failures.append(f"{src.name}:\n{log}")
            else:
                os.replace(tmp, _lib_path(src))
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    if _stale(src):
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(src)))
            _libs[name] = lib
    return lib
