"""The CIM execution-contract auditor (port of ``repro/analysis``).

The paper's speed and energy claims hold only while every planned op
runs on the fused INT8 pipeline.  This package checks that on a run:

- ``manifest`` — the declarative contract (site classes, launches per
  layer derived from the config dims, the TP collectives).
- ``record``   — one step run under a recorder: launches by counter,
  the aten ops around them, the collectives.
- ``passes``   — the audit passes (dispatch, dtype flow, collectives).
- ``auditor``  — build a model, run one step, hold it against the
  manifest (``audit_lm``, ``audit_dit``).
"""
from . import manifest, passes, record  # noqa: F401
from .auditor import (AuditReport, audit_dit, audit_lm,  # noqa: F401
                      full_plan_archs, run_lm_step)
from .passes import (Violation, classify, collective_audit,  # noqa: F401
                     dispatch_audit, dtype_flow_audit)
from .record import Recorder, StepRecord  # noqa: F401
