"""Shared observability flags for the launch CLIs.

Counterpart of ``repro.obs.cli``. Every entry point that can run hot
sections takes the same three flags:

``--obs-events PATH``
    Enable observability and tee every event (resolution, kernel_invoke,
    serving, kv_*, ...) to a JSON-lines file.
``--metrics-out PATH``
    Enable observability and write the Prometheus text exposition of the
    run's metrics to PATH on exit.
``--profile-dir DIR``
    Wrap the run in a ``torch.profiler`` trace, written into DIR as a
    Chrome trace (Perfetto viewable); the repo's hot sections are
    annotated via ``repro_torch.obs.profiling.span``.

Any one of them activates a scoped :class:`~repro_torch.obs.runtime.ObsSession`
for the run; with none passed the run is exactly as uninstrumented as
before (the default: observability off).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

from repro_torch.obs import profiling, runtime


def add_obs_args(ap) -> None:
    """Install the shared observability flags on an ArgumentParser."""
    ap.add_argument("--obs-events", default=None, metavar="PATH",
                    help="enable observability and append every structured "
                         "event (resolution/kernel_invoke/serving/kv_*/...) "
                         "to this JSON-lines file")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="enable observability and write the run's metrics "
                         "as Prometheus text to this file on exit")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="wrap the run in a torch.profiler trace written "
                         "to this directory as a Chrome trace")


@contextlib.contextmanager
def obs_scope(args) -> Iterator["runtime.ObsSession | None"]:
    """Activate observability per the CLI flags for the enclosed run.

    Yields the active :class:`~repro_torch.obs.runtime.ObsSession`, or None when
    no observability flag was passed (the run stays uninstrumented). The
    Prometheus text file, if requested, is written when the block exits —
    after the profiler trace stops, so the export itself is not traced.
    """
    events = getattr(args, "obs_events", None)
    metrics = getattr(args, "metrics_out", None)
    profile = getattr(args, "profile_dir", None)
    if not (events or metrics or profile):
        yield None
        return
    with runtime.using_obs(events_path=events, profile_dir=profile) as sess:
        with profiling.tracing(profile):
            yield sess
        if metrics:
            sess.write_prometheus(metrics)
