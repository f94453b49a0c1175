"""Spans, and ``torch.profiler`` traces behind one CLI flag.

Counterpart of ``repro.obs.profiling`` (``jax.profiler``).
``--profile-dir <dir>`` on the serve CLI wraps the run in :func:`tracing`,
which records ``torch.profiler`` over the CPU, and over the CUDA card when
there is one, and writes a Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``,
viewable in Perfetto or ``chrome://tracing``) into the directory when the
block exits.

Hot sections are annotated with :func:`span`. A span records while an
observability session is active or a ``torch.profiler`` is recording (this
module's :func:`tracing`, or anyone else's); otherwise it is one check of
two globals (:func:`recording`) and touches no clock or
``record_function``. A finished span goes into one bounded, process-wide
ring (:func:`recorded`; the oldest give way, :func:`dropped` counts them)
as a :class:`SpanRecord`: its name, id, its parent's id (the span open on
the same thread when it began), and its start and end on
``time.perf_counter()``. While a profiler records, a span also opens a
``record_function`` range, which puts it on the profiler's clock beside
the kernels, and a span given a device (``wait=``) waits for it at its
ends, so that the kernels it launched run inside it. :func:`add` records a
span after the fact, from given start and end times. Spans are neither
events nor metrics: no exporter reads them.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterator

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs import runtime as _runtime

# Short spins on the card that open every trace: a profile whose first work
# is a CUDA graph replay has lost up to 7 of that replay's kernel records.
# They stay in the trace, as ``spin_kernel``.
PRELUDE_SPINS = 16

RING = 1 << 16          # spans the ring keeps

SpanRecord = collections.namedtuple("SpanRecord", "name id parent start end")

_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = 0
_ring_lock = threading.Lock()
_ids = itertools.count(1)
_open = threading.local()       # .stack: this thread's open spans


def recording() -> bool:
    """True while spans record: a session is active or a profiler is
    recording."""
    return (_runtime.ACTIVE is not None
            or _autograd_profiler._is_profiler_enabled)


def wait_for(device: torch.device | None) -> None:
    """Wait for ``device`` to finish its queued work (a CUDA device; any
    other is a no-op)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack() -> list:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


def _keep(rec: SpanRecord) -> None:
    global _dropped
    with _ring_lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(rec)


def recorded() -> list[SpanRecord]:
    """The spans in the ring, in the order they finished."""
    with _ring_lock:
        return list(_ring)


def dropped() -> int:
    """Spans the ring has let go since the last :func:`reset`."""
    return _dropped


def reset() -> None:
    """Empty the ring (of :data:`RING` spans)."""
    global _ring, _dropped
    with _ring_lock:
        _ring = collections.deque(maxlen=RING)
        _dropped = 0


def add(name: str, start: float, end: float) -> None:
    """Record a finished span from its ``perf_counter`` times, whose start
    may lie well in the past (no ``record_function`` range: the profiler's
    clock has passed it), under the span open on this thread. Call only
    while :func:`recording`."""
    st = _stack()
    _keep(SpanRecord(name, next(_ids), st[-1].id if st else 0, start, end))


class Span:
    """A span open while its ``with`` block runs, recorded when it
    closes."""

    __slots__ = ("name", "id", "parent", "start", "wait", "_rf")

    def __init__(self, name: str, wait: torch.device | None = None):
        self.name, self.wait = name, wait
        self.id, self.parent, self.start, self._rf = next(_ids), 0, 0.0, None

    def __enter__(self) -> "Span":
        st = _stack()
        self.parent = st[-1].id if st else 0
        st.append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
            wait_for(self.wait)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self._rf is not None:
            wait_for(self.wait)
        end = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        st = _stack()
        if self in st:
            del st[st.index(self):]
        _keep(SpanRecord(self.name, self.id, self.parent, self.start, end))
        return False


OFF = contextlib.nullcontext()     # what span() gives while nothing records


def span(name: str, *, wait: torch.device | None = None):
    """A span around a hot section (``with span("serving/launch"):``), or
    :data:`OFF` while nothing records. ``wait``: a device the span waits
    for at its ends while a profiler records."""
    if not recording():
        return OFF
    return Span(name, wait)


@contextlib.contextmanager
def tracing(profile_dir: str | None) -> Iterator[None]:
    """Trace the enclosed block into ``profile_dir`` (no-op when None). A
    profiler that cannot start raises; it never turns into a silent
    no-op."""
    if not profile_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if not torch.autograd.kineto_available():
        raise RuntimeError("torch.profiler cannot trace: this torch build "
                           "has no Kineto")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(str(profile_dir)))
    if cuda:
        torch.cuda.synchronize()    # nothing earlier still running
    prof.start()
    try:
        if cuda:
            for _ in range(PRELUDE_SPINS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        yield
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
