"""``torch.profiler`` over a slice of the measured window.

The harness marks what the host is doing with spans named ``bench/<what>``
(``record_function``: on the profiler's clock, beside the kernels). After
the slice, :meth:`Profile.slice` turns the profiler's events into the
device's kernels and the host's spans; the slice runs from the first span's
start to the last span's end. A short prelude of spins on the card opens
the profile, as ``chip_smoke.py`` does: a profile whose first work is a
CUDA-graph replay has lost some of that replay's kernel records. The spins
are left out of everything read.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

import torch

from perfbench.lib import stats

PRELUDE_SPINS = 16


@dataclasses.dataclass
class Slice:
    kernels: list        # (name, start_us, end_us) of each device operation
    spans: list          # (name, start_us, end_us) of each harness span
    lo: float
    hi: float

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return stats.union_seconds([(s, e) for _, s, e in self.kernels],
                                   self.lo, self.hi) / 1e6

    def time_of(self, pred) -> tuple[int, float]:
        """(operations, device seconds) of the kernels whose name passes
        ``pred``."""
        sel = [(e - s) for n, s, e in self.kernels if pred(n)]
        return len(sel), sum(sel) / 1e6

    def top_ops(self, n: int = 10) -> list:
        """The device operations that took most time, by name."""
        by = defaultdict(float)
        for name, s, e in self.kernels:
            by[name[:160]] += (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches with no device operation, each named by
        the harness span the host was in when it began."""
        spans = sorted(self.spans, key=lambda t: t[1])
        out = []
        for s, e in stats.gaps([(a, b) for _, a, b in self.kernels],
                               self.lo, self.hi):
            name = "outside any span"
            for sn, ss, se in spans:
                if ss <= s < se:
                    name = sn      # the innermost span that holds it
            out.append([name, (e - s) / 1e6])
        return sorted(out, key=lambda t: -t[1])[:n]


class Profile:
    """Off unless ``enabled``: then :meth:`span` marks host spans and
    :meth:`start`/:meth:`stop` bound the profiled slice."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.active = False
        self.error: str | None = None

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.active:
            yield
            return
        with torch.profiler.record_function(f"bench/{name}"):
            yield

    def open_span(self, name: str):
        """A span left open until :meth:`close_span` (across hooks)."""
        if not self.active:
            return None
        rf = torch.profiler.record_function(f"bench/{name}")
        rf.__enter__()
        return rf

    @staticmethod
    def close_span(rf) -> None:
        if rf is not None:
            rf.__exit__(None, None, None)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(PRELUDE_SPINS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        self.active = True

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.active = False
        self.prof.stop()

    def slice(self) -> Slice | None:
        """The slice's kernels and spans (None, with ``error`` set, when
        the profiler gave no device operation)."""
        from torch.autograd import DeviceType
        kernels, spans = [], []
        for e in self.prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                # the device's copies of the host's annotations are ranges,
                # not operations
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("bench/")
                        or "sleep" in e.name or "spin" in e.name):
                    kernels.append((e.name, start, end))
            elif e.name.startswith("bench/"):
                spans.append((e.name[len("bench/"):], start, end))
        self.prof = None
        if not kernels or not spans:
            self.error = (f"profiler gave {len(kernels)} device operations "
                          f"and {len(spans)} harness spans")
            return None
        lo = min(s for _, s, _ in spans)
        hi = max(e for _, _, e in spans)
        return Slice([k for k in kernels if k[2] > lo and k[1] < hi],
                     spans, lo, hi)
