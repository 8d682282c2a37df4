"""Finite-value screening at the kernel/model boundary (port of
``repro/reliability/degrade.py``).

Two halves of the degraded-execution story live here:

* **On the device**: :func:`repro_torch.quant.degraded_mode`, re-exported
  below, screens every fused-pipeline output with one finite reduction
  that writes a flag on the device, and a gated fallback re-runs the
  layer on sanitized operands only when the flag says the screen tripped
  (quant/linear.py).  The serving engines turn it on with
  ``degraded=True``.
* **On the host** (this module): cheap numpy screens over fetched logits
  and latents and a screen over a module's floating tensors, used by
  the engines' health checks and the chaos harness's invariant audits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.quant import degraded_mode  # noqa: F401  (re-export)

__all__ = ["degraded_mode", "finite_rows", "all_finite", "tree_finite"]


def finite_rows(logits: np.ndarray) -> np.ndarray:
    """Per-row finiteness of a [..., vocab] logit block: the engine's
    health-check reduction (a failing row fails only its own request)."""
    return np.isfinite(logits).all(axis=-1)


def all_finite(x) -> bool:
    """Scalar screen over one array (prefill logits, a latent image)."""
    return bool(np.isfinite(np.asarray(x)).all())


def tree_finite(module: torch.nn.Module) -> bool:
    """True when every floating parameter and buffer of ``module`` is
    fully finite (int8 weights are finite by construction and are
    skipped)."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            return False
    return True
