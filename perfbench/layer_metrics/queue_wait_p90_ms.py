"""``queue_wait_p90_ms.<cell>``: the p90 of the time a request waits for a
slot, in milliseconds: the program's ``serving/request/queue`` spans (its
scheduled arrival to the start of the tick that admitted it) of the
requests that arrived inside the measured window, less those whose wait
overlaps the profiled slice (the profiler's start and stop hold the
scheduler up for seconds)."""
from perfbench.lib import program_spans, stats


def read(name, rec):
    lo, hi = rec.window
    held = program_spans.profiled_part(rec.ticks) or (hi, hi)
    waits = [1e3 * (s.end - s.start)
             for s in program_spans.spans("serving/request/queue")
             if lo <= s.start < hi
             and not (s.start < held[1] and s.end > held[0])]
    return stats.percentile(waits, 90)
