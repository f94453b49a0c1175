"""The program's own spans, for the per-layer readers.

The program records spans (``repro_torch.obs.profiling``) into a bounded,
process-wide ring while an observability session is active or a profiler
records, each stamped on ``time.perf_counter()``, the clock the harness
stamps its ticks and steps with. :func:`spans` reads that ring (nothing
where the program keeps none). :func:`offset_us` maps ``perf_counter`` onto
the profiled slice's clock: the harness takes ``Tick.start`` (``Step.start``)
just before it opens its ``step_enqueue`` (``data``) span, so each pair of
the slice's ticks (steps) gives the offset, and the median of the pairs is
taken. Nothing is read where the pairs differ in count or their offsets
spread over ``SPREAD_US``: the median distance of the offsets from their
median, which one late stamp of three (the first span a fresh profiler
opens can take half a millisecond) does not move.
"""
from __future__ import annotations

import statistics

from perfbench.lib import stats

SPREAD_US = 50.0


def spans(name: str) -> list:
    """The program's finished spans named ``name`` (each with ``start``
    and ``end`` in seconds of ``perf_counter``), oldest first; empty where
    the program keeps no ring."""
    try:
        from repro_torch.obs import profiling
    except ImportError:
        return []
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return []
    return [s for s in recorded() if s.name == name]


def offset_us(rec) -> float | None:
    """The slice's clock (us) less ``perf_counter``'s (s, times 1e6), or
    None (see the module's docstring)."""
    s = rec.slice
    if s is None:
        return None
    if rec.steps:
        marks, name = [st.start for st in rec.steps if st.in_slice], "data"
    else:
        marks = [t.start for t in rec.ticks if t.in_slice]
        name = "step_enqueue"
    starts = sorted(st for n, st, _ in s.spans if n == name)
    if not marks or len(starts) != len(marks):
        return None
    offs = [a - 1e6 * b for a, b in zip(starts, marks)]
    mid = statistics.median(offs)
    if statistics.median(abs(o - mid) for o in offs) > SPREAD_US:
        return None
    return mid


def device_busy_us(rec, off: float, start: float, end: float) -> float:
    """Device-busy microseconds of the slice inside the host interval
    [start, end] (``perf_counter`` seconds) mapped by ``off``."""
    lo, hi = 1e6 * start + off, 1e6 * end + off
    return stats.union_seconds([(a, b) for _, a, b in rec.slice.kernels
                                if b > lo and a < hi], lo, hi)


def profiled_part(ticks: list) -> tuple | None:
    """The stretch of the host clock the profiled slice held up: from the
    end of the last tick before the first profiled one (the profiler starts
    after it) to the start of the first tick after the last profiled one
    (None without a profiled tick)."""
    idx = [i for i, t in enumerate(ticks) if t.profiled]
    if not idx:
        return None
    i, j = idx[0], idx[-1]
    lo = ticks[i - 1].end if i > 0 else ticks[i].start
    hi = ticks[j + 1].start if j + 1 < len(ticks) else float("inf")
    return lo, hi


def inside(program: list, intervals) -> list:
    """The spans of ``program`` that start inside one of ``intervals``
    (``(start, end)`` pairs on ``perf_counter``), by interval."""
    return [[p for p in program if a <= p.start < b] for a, b in intervals]
