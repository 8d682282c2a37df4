"""Metrics registry: counters, gauges, fixed-bucket histograms (a copy of
``repro/obs/metrics.py``).

The serving stack's shared instrumentation substrate.  Three metric
kinds, each supporting label sets:

  * :class:`Counter` — monotone float per label set (``inc``);
  * :class:`Gauge` — last-write-wins float per label set (``set``);
  * :class:`Histogram` — fixed upper-bound buckets chosen at
    registration (Prometheus-style cumulative export), tracking per
    label set the bucket counts plus exact sum/count/min/max so means
    are exact and quantiles are bucket-interpolated.

Everything is plain host-side Python: observing a metric never touches
a tensor, so instrumentation cannot perturb a forward or sync the card.
Registries snapshot to a JSON-able dict (``snapshot``) and to the
Prometheus text exposition format (``prometheus_text``); ``reset``
zeroes every series while keeping the registered metric families, so
one registry can span soak after soak with per-phase snapshots.

Quantiles from fixed buckets are estimates (linear interpolation inside
the covering bucket, clamped to the observed min/max); the exported
``sum``/``count`` are exact.  :func:`quantile_from_counts` is the one
shared implementation, so a reported p50/p99 always means the same
computation.
"""
from __future__ import annotations

import json
import math
from typing import Optional, Sequence

_KINDS = ("counter", "gauge", "histogram")


def linear_buckets(start: float, width: float, count: int) -> tuple:
    """``count`` upper bounds: start, start+width, ..."""
    if count < 1 or width <= 0:
        raise ValueError("need count >= 1 and width > 0")
    return tuple(start + i * width for i in range(count))


def exponential_buckets(start: float, factor: float, count: int) -> tuple:
    """``count`` upper bounds: start, start*factor, ..."""
    if count < 1 or start <= 0 or factor <= 1.0:
        raise ValueError("need count >= 1, start > 0, factor > 1")
    return tuple(start * factor ** i for i in range(count))


# Engine-step latency buckets (TTFT / queue-wait / ITL measured on the
# injectable step clock): exact at small step counts, exponential tail
# out past the traffic harness's longest queueing delays.
STEP_BUCKETS = linear_buckets(1, 1, 16) + exponential_buckets(24, 1.5, 16)


def quantile_from_counts(counts: Sequence[float], bounds: Sequence[float],
                         q: float, lo: float, hi: float) -> float:
    """Estimate the ``q`` quantile from cumulative-free bucket counts.

    ``counts`` has ``len(bounds) + 1`` entries (the last is the +inf
    overflow bucket); ``lo``/``hi`` are the observed min/max, which
    bound the estimate and anchor the open first/last buckets.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1], got {q}")
    total = sum(counts)
    if total == 0:
        return 0.0
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        if cum + c >= target or i == len(counts) - 1:
            lower = lo if i == 0 else float(bounds[i - 1])
            upper = hi if i == len(bounds) else float(bounds[i])
            lower = max(lower, lo)
            upper = min(upper, hi)
            if upper <= lower:
                return float(upper)
            frac = (target - cum) / c
            return float(lower + (upper - lower) * min(1.0, max(0.0, frac)))
        cum += c
    return float(hi)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items())) if labels else ()


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.series: dict = {}

    def labelsets(self) -> list:
        return [dict(k) for k in self.series]

    def reset(self) -> None:
        self.series.clear()


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        self.series[key] = self.series.get(key, 0.0) + value

    def add(self, value: float = 1.0) -> None:
        """Unlabeled fast path for per-token/per-step hot loops."""
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.series[()] = self.series.get((), 0.0) + value

    def value(self, **labels) -> float:
        return float(self.series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self.series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self.series.get(_label_key(labels), 0.0))


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1: the +inf overflow
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = STEP_BUCKETS):
        super().__init__(name, help)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram {name}: buckets must be a "
                             f"non-empty strictly-increasing sequence")
        self.buckets = bounds

    def _series(self, labels: dict) -> _HistSeries:
        key = _label_key(labels)
        s = self.series.get(key)
        if s is None:
            s = self.series[key] = _HistSeries(len(self.buckets))
        return s

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        s = self._series(labels)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):      # fixed few-dozen bounds
            if v <= b:
                i = j
                break
        s.counts[i] += 1
        s.sum += v
        s.count += 1
        s.min = min(s.min, v)
        s.max = max(s.max, v)

    # -- reads ---------------------------------------------------------
    def count(self, **labels) -> int:
        s = self.series.get(_label_key(labels))
        return s.count if s else 0

    def mean(self, **labels) -> float:
        s = self.series.get(_label_key(labels))
        return s.sum / s.count if s and s.count else 0.0

    def quantile(self, q: float, **labels) -> float:
        s = self.series.get(_label_key(labels))
        if s is None or not s.count:
            return 0.0
        return quantile_from_counts(s.counts, self.buckets, q, s.min, s.max)


class MetricsRegistry:
    """Named metric families; re-registering an existing name returns
    the same object (kind/bucket mismatches raise loudly)."""

    def __init__(self):
        self._metrics: dict = {}

    def __iter__(self):
        return iter(self._metrics.values())

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def _register(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"a {m.kind}")
            if kw.get("buckets") is not None \
                    and tuple(float(b) for b in kw["buckets"]) != m.buckets:
                raise ValueError(f"histogram {name!r} already registered "
                                 f"with different buckets")
            return m
        m = cls(name, help, **kw) if kw else cls(name, help)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = None) -> Histogram:
        return self._register(Histogram, name, help,
                              buckets=buckets or STEP_BUCKETS)

    def reset(self) -> None:
        for m in self._metrics.values():
            m.reset()

    # -- exporters -----------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dict: kind -> name -> {help, series} (histograms
        additionally carry their bucket bounds and per-series stats)."""
        out: dict = {kind + "s": {} for kind in _KINDS}
        for m in self._metrics.values():
            if isinstance(m, Histogram):
                series = {
                    _label_str(k): {
                        "counts": list(s.counts), "sum": s.sum,
                        "count": s.count,
                        "min": s.min if s.count else 0.0,
                        "max": s.max if s.count else 0.0}
                    for k, s in m.series.items()}
                out["histograms"][m.name] = {
                    "help": m.help, "buckets": list(m.buckets),
                    "series": series}
            else:
                out[m.kind + "s"][m.name] = {
                    "help": m.help,
                    "series": {_label_str(k): v
                               for k, v in m.series.items()}}
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, **kw)

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (histograms cumulative,
        with the canonical ``_bucket``/``_sum``/``_count`` triplet)."""
        def fmt_labels(key: tuple, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in key]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines = []
        for m in self._metrics.values():
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for key, s in m.series.items():
                    cum = 0
                    for bound, c in zip(m.buckets, s.counts):
                        cum += c
                        le = 'le="%g"' % bound
                        lines.append(f"{m.name}_bucket"
                                     f"{fmt_labels(key, le)} {cum}")
                    inf_le = 'le="+Inf"'
                    lines.append(f"{m.name}_bucket"
                                 f"{fmt_labels(key, inf_le)} {s.count}")
                    lines.append(f"{m.name}_sum{fmt_labels(key)} {s.sum:g}")
                    lines.append(f"{m.name}_count{fmt_labels(key)} "
                                 f"{s.count}")
            else:
                for key, v in m.series.items():
                    lines.append(f"{m.name}{fmt_labels(key)} {v:g}")
        return "\n".join(lines) + ("\n" if lines else "")
