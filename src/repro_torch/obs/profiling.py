"""Profiling hooks: ``torch.profiler`` traces behind one CLI flag.

Counterpart of ``repro.obs.profiling`` (``jax.profiler``).
``--profile-dir <dir>`` on the serve CLI wraps the run in :func:`tracing`,
which records ``torch.profiler`` over the CPU, and over the CUDA card when
there is one, and writes a Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``,
viewable in Perfetto or ``chrome://tracing``) into the directory when the
block exits. Hot sections inside the run are annotated with :func:`span`,
which is a no-op unless a trace is active, so the annotations cost nothing
in normal operation, the same contract as the metrics layer.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

# Short spins on the card that open every trace: a profile whose first work
# is a CUDA graph replay has lost up to 7 of that replay's kernel records.
# They stay in the trace, as ``spin_kernel``.
PRELUDE_SPINS = 16

# True while a trace started by tracing() is running; span() guards on it so
# annotations stay free when not profiling.
_TRACING = False


@contextlib.contextmanager
def tracing(profile_dir: str | None) -> Iterator[None]:
    """Trace the enclosed block into ``profile_dir`` (no-op when None). A
    profiler that cannot start raises; it never turns into a silent
    no-op."""
    global _TRACING
    if not profile_dir:
        yield
        return
    import torch
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
    _TRACING = True
    try:
        if cuda:
            for _ in range(PRELUDE_SPINS):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        yield
    finally:
        _TRACING = False
        if cuda:
            torch.cuda.synchronize()
        prof.stop()


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Named trace annotation around a hot section (the serving block step).
    No-op unless :func:`tracing` is active, so call sites can annotate
    unconditionally."""
    if not _TRACING:
        yield
        return
    import torch

    with torch.profiler.record_function(str(name)):
        yield
