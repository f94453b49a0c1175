"""``ssd_roofline.<cell>``: the SSD kernel's (``csrc/ssd_scan.cu``) share
of its roofline in a train step, in percent.

Each call runs one layer's (batch, sequence) of the cell; its bound is the
larger of its FLOPs (``frozen.ssd_flops``) over the bf16 peak and its bytes
(``configs/<costs>.py::ssd_call``: inputs read once, outputs written once)
over 3.35 TB/s. The bound times the calls the profiler recorded, over
their device time.
"""
from perfbench.lib import frozen


def read(name, rec):
    s = rec.slice
    if s is None or not rec.steps:
        return None
    count, sec = s.time_of(lambda n: frozen.kind_of(n) == "ssd_scan")
    if not count or sec <= 0:
        return None
    batch = rec.cell["batch"]
    seq = rec.steps[0].tokens // batch
    flops, nbytes = rec.costs().ssd_call(rec.config, batch, seq,
                                         rec.itemsize)
    bound = max(flops / frozen.PEAK_FLOPS_BF16, nbytes / frozen.HBM_BW)
    return 100.0 * bound * count / sec
