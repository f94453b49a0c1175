"""Metrics primitives for ``repro_torch.obs``: counters, gauges, histograms.

The port's own copy of ``repro.obs.metrics``, line for line: the same
names, help strings, bucket edges and exposition text.

Design constraints (mirroring the rest of the repo's subsystems):

* **Near-zero cost when disabled.** No instrument in this module is ever
  touched unless an :class:`~repro_torch.obs.runtime.ObsSession` is active —
  call sites guard on ``runtime.ACTIVE is not None`` (one global load)
  before constructing label tuples or reading clocks. The registry itself
  therefore optimises for correctness and auditability, not nanoseconds.
* **Thread-safe.** Every subsystem that records (the serving engine, the
  paged pool, the kernel wrappers) records into one registry, from
  whatever thread it runs on; every mutation takes the registry lock.
  Snapshots are consistent.
* **Fixed bucket edges.** Histograms use explicit, immutable bucket
  uppers (Prometheus ``le`` semantics: cumulative counts of observations
  ``<= edge``, with a ``+Inf`` bucket always present), so two runs of the
  same binary export comparable series and the regression gate can diff
  them structurally.

Exporters: :meth:`MetricsRegistry.prometheus_text` renders the standard
Prometheus text exposition format; :meth:`MetricsRegistry.snapshot`
returns plain dicts for the JSON-lines exporter in ``repro_torch.obs.events``.
"""
from __future__ import annotations

import threading
from typing import Iterable, Mapping

# Latency-shaped default edges (seconds): sub-millisecond ticks on a warm
# CPU host through multi-second cold compiles all land in a real bucket.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Mapping[str, object]) -> tuple:
    """Normalise a label mapping to a hashable, sorted series key."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    """Prometheus label block for one series key (empty string when the
    series is unlabelled)."""
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Instrument:
    """Shared per-metric state: name, help text, per-series values."""

    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: dict[tuple, object] = {}

    def series(self) -> dict[tuple, object]:
        with self._lock:
            return dict(self._series)


class Counter(_Instrument):
    """Monotonically increasing count, optionally labelled."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative inc {amount}")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + amount

    def value(self, **labels) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(_Instrument):
    """Last-set value, optionally labelled."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float | None:
        with self._lock:
            return self._series.get(_label_key(labels))


class Histogram(_Instrument):
    """Fixed-bucket histogram (Prometheus ``le`` semantics).

    Each series holds cumulative bucket counts for the configured edges
    plus the implicit ``+Inf`` bucket, and running ``sum``/``count`` so
    mean latencies and phase-time totals are recoverable exactly.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, lock)
        edges = tuple(sorted(float(e) for e in buckets))
        if not edges:
            raise ValueError(f"histogram {self.name}: no bucket edges")
        if len(set(edges)) != len(edges):
            raise ValueError(f"histogram {name}: duplicate bucket edges")
        self.buckets = edges

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"counts": [0] * (len(self.buckets) + 1),
                     "sum": 0.0, "count": 0}
                self._series[key] = s
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    s["counts"][i] += 1
                    break
            else:
                s["counts"][-1] += 1           # +Inf bucket
            s["sum"] += float(value)
            s["count"] += 1

    def stats(self, **labels) -> dict | None:
        """``{"sum", "count", "counts"}`` for one series (None if never
        observed). ``counts`` are per-bucket (non-cumulative) in edge
        order with the ``+Inf`` bucket last."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            return None if s is None else {"sum": s["sum"],
                                           "count": s["count"],
                                           "counts": list(s["counts"])}


class MetricsRegistry:
    """One process-wide family of named instruments.

    ``counter()``/``gauge()``/``histogram()`` are get-or-create: the first
    call fixes the kind (and a histogram's bucket edges); a later call
    under the same name with a different kind raises — a silently forked
    metric is exactly the failure mode an observability layer must not
    have.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kw) -> _Instrument:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Instrument | None:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Plain-dict dump of every metric (JSON-serialisable)."""
        out: dict[str, dict] = {}
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in sorted(metrics.items()):
            entry: dict = {"kind": m.kind, "help": m.help, "series": []}
            if isinstance(m, Histogram):
                entry["buckets"] = list(m.buckets)
            for key, val in sorted(m.series().items()):
                labels = dict(key)
                if isinstance(m, Histogram):
                    entry["series"].append(
                        {"labels": labels, "sum": val["sum"],
                         "count": val["count"],
                         "counts": list(val["counts"])})
                else:
                    entry["series"].append({"labels": labels, "value": val})
            out[name] = entry
        return out

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition of every metric."""
        lines: list[str] = []
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in sorted(metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key, val in sorted(m.series().items()):
                if isinstance(m, Histogram):
                    cum = 0
                    for edge, c in zip(m.buckets, val["counts"]):
                        cum += c
                        lkey = key + (("le", _fmt(edge)),)
                        lines.append(
                            f"{name}_bucket{_label_str(lkey)} {cum}")
                    cum += val["counts"][-1]
                    lkey = key + (("le", "+Inf"),)
                    lines.append(f"{name}_bucket{_label_str(lkey)} {cum}")
                    lines.append(
                        f"{name}_sum{_label_str(key)} {_fmt(val['sum'])}")
                    lines.append(
                        f"{name}_count{_label_str(key)} {val['count']}")
                else:
                    lines.append(f"{name}{_label_str(key)} {_fmt(val)}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v) -> str:
    """Compact numeric rendering (ints stay ints; floats use repr)."""
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)
