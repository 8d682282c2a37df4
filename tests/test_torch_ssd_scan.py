"""Kernel 13 (the chunked Mamba-2 SSD scan) of the port against the JAX
reference, on the CPU.

The plain version (what ``repro_torch.kernels.ops.ssd_scan`` runs for
CPU tensors: the Pallas body chunk by chunk in f32) is held against the
Pallas kernel in interpret mode, against the naive recurrence of
``repro.kernels.ref.ssd_scan_ref`` and against the model path's
``repro.models.ssm.ssd_chunked``, on the same numpy inputs, at the JAX
tests' tolerance of 2e-4 for y and the final state.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import ssd_chunked

from repro_torch.kernels import launch_counts, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as ss
from torch_parity import rng, t, to_np

TOL = 2e-4


def _inputs(seed, BH, S, P, N):
    r = rng(seed)
    x = r.standard_normal((BH, S, P)).astype(np.float32)
    la = (-np.abs(r.standard_normal((BH, S))) * 0.3).astype(np.float32)
    b = r.standard_normal((BH, S, N)).astype(np.float32)
    c = r.standard_normal((BH, S, N)).astype(np.float32)
    return (x, la, b, c)


def _close(a, b):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_plain_matches_jax_kernel_and_naive(chunk):
    arrs = _inputs(1, 4, 128, 16, 8)
    y, h = ops.ssd_scan(*(t(a) for a in arrs), chunk=chunk)
    jy, jh = jops.ssd_scan(*(jnp.asarray(a) for a in arrs), chunk=chunk,
                           interpret=True)
    ry, rh = jref.ssd_scan_ref(*(jnp.asarray(a) for a in arrs))
    ty, th = tref.ssd_scan_ref(*(t(a) for a in arrs))
    assert y.shape == (4, 128, 16) and h.shape == (4, 16, 8)
    for got, want in ((y, jy), (h, jh), (y, ry), (h, rh), (ty, ry),
                      (th, rh)):
        _close(got, want)


def test_plain_matches_model_ssd_chunked():
    """The heads of ``ssd_chunked`` (b and c shared by a group of heads,
    broadcast to each head) flattened into BH rows."""
    B, S, H, P, N = 2, 64, 2, 8, 4
    r = rng(2)
    x = r.standard_normal((B, S, H, P)).astype(np.float32)
    la = (-np.abs(r.standard_normal((B, S, H))) * 0.3).astype(np.float32)
    b = r.standard_normal((B, S, 1, N)).astype(np.float32)
    c = r.standard_normal((B, S, 1, N)).astype(np.float32)
    y_m, h_m = ssd_chunked(jnp.asarray(x), jnp.asarray(la), jnp.asarray(b),
                           jnp.asarray(c), 16)
    xf = x.transpose(0, 2, 1, 3).reshape(B * H, S, P)
    laf = la.transpose(0, 2, 1).reshape(B * H, S)
    bf = np.repeat(b, H, 2).transpose(0, 2, 1, 3).reshape(B * H, S, N)
    cf = np.repeat(c, H, 2).transpose(0, 2, 1, 3).reshape(B * H, S, N)
    y, h = ops.ssd_scan(t(xf), t(laf), t(bf), t(cf), chunk=16)
    _close(to_np(y).reshape(B, H, S, P).transpose(0, 2, 1, 3), y_m)
    _close(to_np(h).reshape(B, H, P, N), h_m)


@pytest.mark.parametrize("S,chunk", [(100, 32), (37, 128), (64, 1)])
def test_ragged_last_chunk_matches_naive(S, chunk):
    """The kernel wrapper takes S that the chunk does not divide (the
    last chunk is shorter); the chunked form is the same function."""
    arrs = [t(a) for a in _inputs(3, 3, S, 8, 4)]
    y, h = ss.ssd_scan(*arrs, chunk=chunk)
    ry, rh = tref.ssd_scan_ref(*arrs)
    _close(y, ry)
    _close(h, rh)


def test_chunk_must_divide_as_in_the_reference():
    arrs = [t(a) for a in _inputs(4, 2, 96, 8, 4)]
    ops.ssd_scan(*arrs, chunk=32)
    ops.ssd_scan(*arrs)               # chunk = min(128, S)
    with pytest.raises(ValueError):
        ops.ssd_scan(*arrs, chunk=64)
    with pytest.raises(ValueError):
        ss.ssd_scan(*arrs, chunk=0)


def test_cpu_calls_launch_nothing_and_devices_must_agree():
    x, la, b, c = (t(a) for a in _inputs(5, 2, 32, 8, 4))
    before = launch_counts()
    ops.ssd_scan(x, la, b, c, chunk=16)
    assert launch_counts() == before
    with pytest.raises(ValueError):
        ss.ssd_scan(x, la.to("meta"), b, c)
