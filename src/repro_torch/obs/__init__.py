"""Runtime observability: metrics registry, per-request tracing, and
live dispatch/energy attribution for the serving stack (port of
``repro/obs``).

Quickstart::

    from repro_torch.obs import Observability
    obs = Observability()
    engine = PagedServingEngine(model, obs=obs, ...)
    ...serve traffic...
    print(obs.registry.prometheus_text())
    json.dump(obs.snapshot(), open("snap.json", "w"))

The modelled joules and MACs are the paper's CIM-TPU (``core/``), not
the card's energy.
"""
from .attribution import (EnergyAttribution, StepPrice, default_hardware,
                          plan_covers_dit, plan_covers_model)
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      STEP_BUCKETS, exponential_buckets, linear_buckets,
                      quantile_from_counts)
from .observability import Observability
from .tracing import EventLog, RequestTrace

__all__ = [
    "Counter", "EnergyAttribution", "EventLog", "Gauge", "Histogram",
    "MetricsRegistry", "Observability", "RequestTrace", "STEP_BUCKETS",
    "StepPrice", "default_hardware", "exponential_buckets",
    "linear_buckets", "plan_covers_dit", "plan_covers_model",
    "quantile_from_counts",
]
