"""Reliability layer (port of ``repro/reliability``): CIM fault
injection, degraded-mode execution, and the chaos harness for the
serving engines.

* hardware/quant — seeded weight-memory fault models over the int8
  ``QuantizedLinear`` buffers per CIM-macro geometry, bit for bit the
  reference's campaigns, with mitigations (outlier-channel protection,
  modeled SECDED ECC costed by the simulator via
  ``EnergyModel.with_cim_ecc``): faults.py;
* kernel/model boundary — a finite screen on the device and a gated
  fallback on sanitized operands per quantized layer
  (``degraded_mode``): degrade.py;
* serving — deterministic mid-serve chaos against the engines' request
  lifecycle (``RequestStatus``, deadlines, backpressure, health
  checks): chaos.py.
"""
from .chaos import (ChaosMonkey, ChaosReport, SoakResult,
                    assert_all_terminal, chaos_soak,
                    engine_invariant_violations)
from .degrade import all_finite, degraded_mode, finite_rows, tree_finite
from .faults import (FAULT_KINDS, FaultConfig, FaultReport, Leaf,
                     ecc_residual_ber, inject_int8, inject_tree,
                     load_leaves, protect_tree, quantized_leaves)

__all__ = [
    "FAULT_KINDS", "FaultConfig", "FaultReport", "inject_int8",
    "inject_tree", "protect_tree", "ecc_residual_ber",
    "degraded_mode", "finite_rows", "all_finite", "tree_finite",
    "ChaosMonkey", "ChaosReport", "SoakResult", "chaos_soak",
    "assert_all_terminal", "engine_invariant_violations",
    "Leaf", "quantized_leaves", "load_leaves",
]
