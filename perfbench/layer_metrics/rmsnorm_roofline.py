"""``rmsnorm_roofline.t<T>.<cell>``: the RMSNorm kernel's share of its
roofline over the block steps of T tokens, in percent.

The profiled slice's kernels are split by block step: a step's kernels are
those that start from its ``step_enqueue`` span on and before the next
step's (each step's tokens are fetched before the next is called, so its
kernels end before the next begins). For each step of T tokens in the
slice, the RMSNorm calls it makes (``configs/<costs>.py::rmsnorm_calls``),
each bound by the larger of its FLOPs over the bf16 peak and its bytes
(input and weight read once, output written once) over 3.35 TB/s; the mean
bound a call, over the mean device time of those steps' ``rmsnorm``
kernels. Nothing is read where the slice holds no step of T tokens, or
where the kernel's count strays over 5% from the calls the steps make (the
kernel is not where the count expects it).
"""
from perfbench.lib import frozen


def read(name, rec):
    t_len = int(name.split(".")[1][1:])
    s = rec.slice
    ticks = [t for t in rec.ticks if t.in_slice]
    if s is None or not ticks:
        return None
    starts = sorted(st for n, st, _ in s.spans if n == "step_enqueue")
    if len(starts) != len(ticks):
        return None
    costs = rec.costs()
    bound, calls, count, sec = 0.0, 0, 0, 0.0
    for t, lo, hi in zip(ticks, starts, starts[1:] + [s.hi]):
        if t.t_len != t_len:
            continue
        for rows, width in costs.rmsnorm_calls(rec.config, len(t.n_valid),
                                               t.t_len):
            nbytes = costs.rmsnorm_bytes(rows, width, rec.itemsize)
            bound += max(nbytes / frozen.HBM_BW,
                         frozen.rmsnorm_flops(rows * width)
                         / frozen.PEAK_FLOPS_BF16)
            calls += 1
        mine = [(e - st) / 1e6 for k, st, e in s.kernels
                if lo <= st < hi and frozen.kind_of(k) == "rmsnorm"]
        count, sec = count + len(mine), sec + sum(mine)
    if not calls or not count or abs(count - calls) > 0.05 * calls:
        return None
    return 100.0 * (bound / calls) / (sec / count)
