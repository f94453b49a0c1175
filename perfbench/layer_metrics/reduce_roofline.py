"""``reduce_roofline.<cell>``: the tensor-core reduce's
(``csrc/tcu_reduce.cu``) share of its roofline in a train step's global
norm, in percent.

A step reduces every parameter leaf's squared gradient, one float32 row a
leaf (the leaves of the configuration's reference tree): each call bound
by its bytes read once and its sum written once over 3.35 TB/s. The
bound of the whole steps inside the profiled slice, over the device time
of the ``reduce`` kernels there.
"""
import math

from perfbench.lib import frozen, manifest, weights


def read(name, rec):
    s = rec.slice
    steps = sum(1 for st in rec.steps if st.in_slice)
    if s is None or not steps:
        return None
    count, sec = s.time_of(lambda n: frozen.kind_of(n) == "reduce")
    if not count or sec <= 0:
        return None
    specs = manifest.reference(rec.config).param_specs(rec.config)
    bound = sum(max((math.prod(leaf.shape) + 1) * 4 / frozen.HBM_BW,
                    math.prod(leaf.shape) / frozen.PEAK_FLOPS_BF16)
                for _, leaf in weights._leaves(specs))
    return 100.0 * bound * steps / sec
