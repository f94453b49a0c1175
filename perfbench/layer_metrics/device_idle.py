"""``device_idle.<cell>``: the share of the profiled slice in which no
operation ran on the device, in percent (the union of the profiler's
device operations against the slice's length)."""


def read(name, rec):
    s = rec.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
