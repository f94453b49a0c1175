"""``sched_host_ms.<cell>``: the scheduler's host milliseconds a tick.

The serving engine's observed tick phases ``admission`` (refilling slots)
and ``bookkeep`` (recording tokens, freeing slots), summed over the
window's ticks (less the profiled slice) and divided by those ticks. Read
from the program's ``repro_serving_tick_phase_seconds`` histogram, whose
sums and counts are exact.
"""


def read(name, rec):
    p = rec.phases
    if not p or not p["ticks"]:
        return None
    return 1e3 * (p["admission"] + p["bookkeep"]) / p["ticks"]
