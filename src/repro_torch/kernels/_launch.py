"""Shared checks and launch plumbing for the CUDA kernel wrappers.

A wrapper takes the plain version only for a tensor on the CPU; for a
CUDA tensor it launches its kernel or raises.  It checks device, dtype,
shape and contiguity, allocates outputs with ``torch.empty`` and
launches on the current stream.
"""
from __future__ import annotations

import ctypes
import sys

import torch

from . import _build

ACTIVATIONS = {None: 0, "gelu": 1, "silu": 2, "relu": 3}
# dtype codes of the C entry points
DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}


# Called with the wrapper's code object each time a wrapper takes its
# plain version (None: nobody listens).  ``analysis.record.Recorder``
# sets it to count the wrappers' calls on the CPU, where no launch
# counter moves.
observer = None


def on_cpu(*tensors: torch.Tensor | None) -> bool:
    """True if the call takes the plain version: every tensor on the CPU.

    Raises for any other device and for a CPU/CUDA mix, and on the card
    for a call that autograd would have to differentiate (grad mode on
    and an input that requires grad): no kernel has a backward, so its
    output would silently cut the gradient.  A kernel that takes part in
    training is launched from an ``autograd.Function``'s forward, where
    grad mode is off.  On the CPU the plain versions are torch ops and
    stay differentiable."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        if observer is not None:
            observer(sys._getframe(1).f_code)
        return True
    if devs == {"cuda"}:
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in tensors):
            raise RuntimeError(
                f"{sys._getframe(1).f_code.co_name}: the kernel has no "
                f"backward, and an input requires grad; run it under "
                f"torch.no_grad() or through an autograd.Function")
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on one CUDA "
                     f"device, got {sorted(devs)}")


def require(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    if not isinstance(dtypes, tuple):
        dtypes = (dtypes,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def bind(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    fn = getattr(_build.load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, err: int, what: str) -> None:
    if err != 0:
        lib = _build.load(lib_name)
        to_str = getattr(lib, f"{lib_name}_error_string")
        to_str.restype = ctypes.c_char_p
        to_str.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA launch failed: "
                           f"{to_str(err).decode()} ({err})")


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
