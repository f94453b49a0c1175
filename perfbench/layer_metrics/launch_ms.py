"""``launch_ms.t<T>.<cell>``: mean host milliseconds a block step of T
tokens spends in the program's ``serving/launch`` span (the CUDA graph's
``replay()`` call), over the window's ticks of that T outside the profiled
slice. Nothing is read unless every such tick holds the span."""
from perfbench.lib import program_spans


def read(name, rec):
    t_len = int(name.split(".")[1][1:])
    ticks = rec.window_ticks(t_len, unprofiled=True)
    held = program_spans.inside(program_spans.spans("serving/launch"),
                                [(t.start, t.end) for t in ticks])
    if not ticks or not all(held):
        return None
    return 1e3 * sum(s.end - s.start for mine in held for s in mine) \
        / len(ticks)
