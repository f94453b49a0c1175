"""``other_device_ms.<cell>``: device milliseconds a train step in kernels
that are neither matrix products (cuBLAS, CUTLASS) nor the port's own
``csrc`` kernels: torch's elementwise passes, reductions, copies. Over the
whole steps of the profiled slice."""
from perfbench.lib import frozen


def _other(name: str) -> bool:
    return frozen.kind_of(name) == "other" and not frozen.is_port_kernel(name)


def read(name, rec):
    steps = sum(1 for st in rec.steps if st.in_slice)
    if rec.slice is None or not steps:
        return None
    return 1e3 * rec.slice.time_of(_other)[1] / steps
