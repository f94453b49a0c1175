"""repro_torch.obs — unified observability: metrics, tracing, profiling.

The port's counterpart of ``repro.obs``: the same events, counters, gauges
and histograms under the same names, labels and help strings. Off by
default; scoped-enable mirrors ``using_policy``::

    from repro_torch import obs

    with obs.using_obs(events_path="events.jsonl") as sess:
        ...                       # kernels/serving/training record here
        print(sess.prometheus_text())

Submodules:

* :mod:`repro_torch.obs.metrics` — counters/gauges/histograms + exporters.
* :mod:`repro_torch.obs.cli` — the shared ``--obs-events`` /
  ``--metrics-out`` / ``--profile-dir`` flags for the launch CLIs.
* :mod:`repro_torch.obs.events` — bounded event ring + JSON-lines tee; the
  resolution-event schema (:data:`RESOLUTION_FIELDS`).
* :mod:`repro_torch.obs.runtime` — the active-session machinery
  (``enable``/``disable``/``using_obs``/``active``).
* :mod:`repro_torch.obs.profiling` — spans (a bounded process-wide ring,
  live while a session or a profiler records) and the ``torch.profiler``
  trace behind ``--profile-dir``.
"""
from repro_torch.obs.events import (DEFAULT_RING, RESOLUTION_FIELDS,
                                    EventSink, format_resolution, load_jsonl)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.profiling import span, tracing
from repro_torch.obs.runtime import (ObsSession, active, disable, emit,
                                     enable, using_obs)

__all__ = [
    "DEFAULT_BUCKETS", "DEFAULT_RING", "RESOLUTION_FIELDS",
    "Counter", "EventSink", "Gauge", "Histogram", "MetricsRegistry",
    "ObsSession", "active", "disable", "emit", "enable",
    "format_resolution", "load_jsonl", "span", "tracing", "using_obs",
]
