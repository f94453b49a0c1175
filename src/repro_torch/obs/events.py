"""Structured event stream for ``repro_torch.obs``: bounded ring + JSON-lines.

The port's own copy of ``repro.obs.events``, line for line: the same
resolution schema, ring size and JSON-lines format.

An *event* is a flat dict: ``{"kind": <str>, "ts": <unix seconds>, ...}``
plus kind-specific fields. The two kinds every tool in the repo agrees on:

``resolution``
    One ``core.policy.resolve()`` call. Fields (the dispatch-audit
    schema — see :data:`RESOLUTION_FIELDS`): ``op``, ``n`` (the caller's
    bucket-axis size), ``shard_n`` (after a shard division; the port
    shards nothing yet, so ``n``), ``shard_divisor``, ``dtype``
    (canonical tag, e.g. ``"f32"``), ``backend`` (``gpu`` on the card,
    ``cpu`` on the CPU), ``band`` (log2 bucket), ``level``
    (``dispatch``/``kernel``), ``explicit`` (the per-call path label or
    None), ``chosen_path``, ``tuning`` (knob dict or None) and
    ``table_src`` (the autotune table file that supplied the bucket, else
    ``"heuristic"``/``"static"``/``"none"``).
``kernel_invoke``
    One call of a public kernel wrapper (``repro_torch.kernels.ops``):
    ``op`` (the reference's registry spelling), ``n``, ``dtype``,
    ``path``, ``tuning``.

Everything else (``serving``, ``train_step``, ``ckpt``, ...) is
free-form but follows the same flat-dict convention so one JSON-lines
file interleaves all subsystems on a shared clock.

The sink keeps a bounded in-memory ring (newest-wins, so a long serving
run cannot grow without bound — the fix for the unbounded
``ServingEngine.trace`` list) and optionally appends each event to a
JSON-lines file as it is emitted. Both paths are thread-safe.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

# The resolution-event schema, in emission order. Exported so the CI
# schema check and the tests validate against one source of truth.
RESOLUTION_FIELDS = ("op", "n", "shard_n", "shard_divisor", "dtype",
                    "backend", "band", "level", "explicit", "chosen_path",
                    "tuning", "table_src")

DEFAULT_RING = 4096


class EventSink:
    """Bounded event ring with an optional JSON-lines tee.

    ``ring`` caps the in-memory history (oldest events drop first);
    ``jsonl_path`` appends every event as one JSON object per line. A
    non-serialisable field value is stringified rather than dropping the
    event — an audit stream must not lose records to a repr quirk.
    """

    def __init__(self, ring: int = DEFAULT_RING,
                 jsonl_path: str | None = None):
        if ring < 1:
            raise ValueError(f"event ring must be >= 1, got {ring}")
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=int(ring))
        self._emitted = 0
        self._path = str(jsonl_path) if jsonl_path else None
        self._file = open(self._path, "a") if self._path else None

    @property
    def jsonl_path(self) -> str | None:
        return self._path

    @property
    def emitted(self) -> int:
        """Total events emitted (including any that fell off the ring)."""
        with self._lock:
            return self._emitted

    def emit(self, kind: str, **fields) -> dict:
        event = {"kind": str(kind), "ts": time.time(), **fields}
        with self._lock:
            self._emitted += 1
            self._ring.append(event)
            if self._file is not None:
                self._file.write(json.dumps(event, default=str) + "\n")
                self._file.flush()
        return event

    def events(self, kind: str | None = None) -> list[dict]:
        """The ring's current contents, oldest first (filtered by kind)."""
        with self._lock:
            evs = list(self._ring)
        if kind is None:
            return evs
        return [e for e in evs if e.get("kind") == kind]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None


def load_jsonl(path: str) -> list[dict]:
    """Read a JSON-lines event file back into a list of event dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def format_resolution(event: dict) -> str:
    """One-line human rendering of a resolution-shaped event dict.

    Shared by the JSON-lines consumers and the reference's ``python -m
    repro.core.autotune --check`` staleness diff, so the audit trail and
    the CI gate speak the same dialect. Tolerates partial dicts (missing
    fields print as ``-``), because the --check diff renders table
    *entries*, which carry path/tuning but no live call shape.
    """
    def g(key, default="-"):
        v = event.get(key)
        return default if v is None else v

    tuning = event.get("tuning")
    tuning_s = ";".join(f"{k}={v}" for k, v in sorted(tuning.items())) \
        if isinstance(tuning, dict) and tuning else "-"
    parts = [f"op={g('op')}", f"n={g('n')}", f"dtype={g('dtype')}",
             f"band={g('band')}", f"backend={g('backend')}",
             f"level={g('level')}"]
    if event.get("shard_divisor") not in (None, 1):
        parts.append(f"shard_divisor={event['shard_divisor']}"
                     f"(shard_n={g('shard_n')})")
    parts += [f"path={g('chosen_path')}", f"tuning={tuning_s}",
              f"src={g('table_src')}"]
    return " ".join(parts)
