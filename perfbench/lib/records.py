"""What a run hands the per-layer readers.

A reader (``layer_metrics/<base>.py``) has ``read(name, rec) -> float |
None``: it takes its number from these records, or returns None where it
finds nothing to read (then the metric is left out of the line).
"""
from __future__ import annotations

import dataclasses
import numpy as np

from perfbench.lib import manifest


@dataclasses.dataclass
class Tick:
    """One block step of the serving engine, stamped by the harness from
    the step's call to its sampled tokens' return."""
    t_len: int
    start: float
    n_valid: np.ndarray
    reset: np.ndarray
    end: float = 0.0
    in_window: bool = False
    profiled: bool = False       # inside the profiled slice, or just after
    in_slice: bool = False       # inside the profiled slice


@dataclasses.dataclass
class Step:
    """One train step, from the batch's fetch to the loss on the host."""
    start: float
    end: float
    tokens: int
    in_window: bool = False
    profiled: bool = False       # inside the profiled slice, or just after
    in_slice: bool = False       # inside the profiled slice


@dataclasses.dataclass
class Records:
    cell: dict
    config: dict
    window: tuple                 # (start, end) on the host clock
    ticks: list = dataclasses.field(default_factory=list)
    steps: list = dataclasses.field(default_factory=list)
    phases: dict | None = None    # obs tick-phase seconds in the window
    slice: object = None          # trace.Slice of the profiled part
    itemsize: int = 2             # bytes of the model's dtype

    def window_ticks(self, t_len: int | None = None,
                     unprofiled: bool = False) -> list:
        return [t for t in self.ticks if t.in_window
                and (t_len is None or t.t_len == t_len)
                and not (unprofiled and t.profiled)]

    def costs(self):
        """The configuration's counting module (``configs/<costs>.py``)."""
        name = self.config["costs"]
        return manifest.load(manifest.PACKAGE / "configs" / f"{name}.py",
                             f"perfbench_costs_{name}")
