"""``tick_ms.t<T>.<cell>``: mean host milliseconds of a block step of T
tokens, from the step's call to its sampled tokens' return (a CUDA-graph
replay and the fetch that waits for it), over the window's ticks of that T
outside the profiled slice.
"""


def read(name, rec):
    t_len = int(name.split(".")[1][1:])
    ticks = rec.window_ticks(t_len, unprofiled=True)
    if not ticks:
        return None
    return 1e3 * sum(t.end - t.start for t in ticks) / len(ticks)
