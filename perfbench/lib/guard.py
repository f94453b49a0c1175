"""What a run must not load or read.

The benchmark measures the port alone: neither JAX nor the JAX package
(``repro``) may be in the process, compared by whole top-level module
names (``repro_torch`` is not ``repro``), and nothing under ``benchmarks/``
(the JAX package's old CPU benchmark) may be opened.
"""
from __future__ import annotations

import os
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (the names of
    ``sys.modules`` by default)."""
    names = list(sys.modules) if names is None else names
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN))


class ReadGuard:
    """Records every file opened under ``<root>/benchmarks`` (an audit
    hook on ``open``; it stays for the life of the process)."""

    def __init__(self, root: Path):
        self.prefix = str((root / "benchmarks").resolve()) + os.sep
        self.seen: list[str] = []
        sys.addaudithook(self._hook)

    def _hook(self, event: str, args) -> None:
        if event != "open" or not args:
            return
        path = args[0]
        if isinstance(path, bytes):
            path = path.decode(errors="replace")
        if not isinstance(path, str):
            return
        full = os.path.abspath(path)
        if full.startswith(self.prefix):
            self.seen.append(full)
