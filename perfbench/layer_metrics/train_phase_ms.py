"""``train_phase_ms.<phase>.<cell>``: device-busy milliseconds a profiled
train step inside the program's ``train/<phase>`` spans (``forward``,
``backward``, ``clip``, ``update``). The spans wait for the device at their
ends while they record, so a phase's kernels run inside its span: each
span of the slice's steps is mapped onto the slice's clock
(``lib/program_spans.py``) and the union of the device operations inside
it is summed, over the slice's steps."""
from perfbench.lib import program_spans


def read(name, rec):
    phase = name.split(".")[1]
    steps = [st for st in rec.steps if st.in_slice]
    off = program_spans.offset_us(rec)
    if off is None or not steps:
        return None
    held = program_spans.inside(program_spans.spans(f"train/{phase}"),
                                [(st.start, st.end) for st in steps])
    if not all(held):
        return None
    busy_us = sum(program_spans.device_busy_us(rec, off, s.start, s.end)
                  for mine in held for s in mine)
    return busy_us / 1e3 / len(steps)
