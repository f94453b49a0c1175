"""The active observability session — ``repro_torch.obs``'s ``get_policy``.

The port's own copy of ``repro.obs.runtime``, line for line.

Observability is **off by default** and scoped-enable, mirroring the
kernel-policy layer's ``using_policy``: nothing in the repo records a
metric or emits an event unless a session is active, and the hot-path
check is a single module-global load (``runtime.ACTIVE is not None``) so
the disabled path adds no measurable work to ``core.policy.resolve()``
or the serving tick loop.

Unlike the policy layer, the active session is a *process* global, not a
context-var: the instrumented subsystems span threads the enabling frame
never sees (the serving engine's caller, a CUDA graph's capture on a
side stream), and a per-context session would silently lose exactly
those records. ``using_obs`` still nests — it saves and
restores the previous session — it just isn't thread-local.

Typical use::

    from repro_torch import obs

    with obs.using_obs(events_path="events.jsonl") as sess:
        engine.run(requests)
        print(sess.metrics.prometheus_text())
        for e in sess.events.events("resolution"):
            print(obs.format_resolution(e))
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from repro_torch.obs.events import DEFAULT_RING, EventSink
from repro_torch.obs.metrics import MetricsRegistry

# THE hot-path flag: instrumented call sites guard on ``ACTIVE is not
# None`` before doing any observability work. Assigned only under _LOCK.
ACTIVE: "ObsSession | None" = None

_LOCK = threading.Lock()


class ObsSession:
    """One observability scope: a metrics registry + an event sink.

    ``events_path`` tees every event to a JSON-lines file; ``ring`` caps
    the in-memory event history; ``profile_dir`` is carried for the
    profiling hooks (``repro_torch.obs.profiling``) so one flag threads
    through the CLIs.
    """

    def __init__(self, *, events_path: str | None = None,
                 ring: int = DEFAULT_RING,
                 profile_dir: str | None = None):
        self.metrics = MetricsRegistry()
        self.events = EventSink(ring=ring, jsonl_path=events_path)
        self.profile_dir = profile_dir

    # -- convenience passthroughs ------------------------------------------

    def emit(self, kind: str, **fields) -> dict:
        return self.events.emit(kind, **fields)

    def counter(self, name: str, help: str = ""):
        return self.metrics.counter(name, help)

    def gauge(self, name: str, help: str = ""):
        return self.metrics.gauge(name, help)

    def histogram(self, name: str, help: str = "", **kw):
        return self.metrics.histogram(name, help, **kw)

    def prometheus_text(self) -> str:
        return self.metrics.prometheus_text()

    def write_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.metrics.prometheus_text())

    def close(self) -> None:
        self.events.close()


def active() -> ObsSession | None:
    """The active session, or None (the default: observability off)."""
    return ACTIVE


def enable(session: ObsSession | None = None, **kw) -> ObsSession:
    """Install ``session`` (or a fresh one built from ``kw``) as the
    active session and return it. Prefer the scoped :func:`using_obs`
    unless the session should outlive the frame."""
    global ACTIVE
    sess = session if session is not None else ObsSession(**kw)
    with _LOCK:
        ACTIVE = sess
    return sess


def disable() -> None:
    """Deactivate observability (the active session, if any, is left
    intact for post-hoc reads — only emission stops)."""
    global ACTIVE
    with _LOCK:
        ACTIVE = None


@contextlib.contextmanager
def using_obs(session: ObsSession | None = None,
              **kw) -> Iterator[ObsSession]:
    """Scoped observability: activate a session, restore the previous one
    (usually None) on exit. The session's JSON-lines file, if any, is
    closed on exit; its in-memory metrics/events stay readable."""
    global ACTIVE
    sess = session if session is not None else ObsSession(**kw)
    with _LOCK:
        prev, ACTIVE = ACTIVE, sess
    try:
        yield sess
    finally:
        with _LOCK:
            ACTIVE = prev
        if session is None:       # we own the sink: release the file
            sess.close()


def emit(kind: str, **fields) -> dict | None:
    """Emit one event into the active session (no-op when disabled)."""
    sess = ACTIVE
    return None if sess is None else sess.emit(kind, **fields)
