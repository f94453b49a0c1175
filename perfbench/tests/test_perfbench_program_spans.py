"""The readers of the program's spans (``lib/program_spans.py``) on
hand-made records and spans: the clock pairing, each reader's number
against a hand count, and a CPU run of the chat cell that leaves the
program's queue and tick spans in its ring."""
import numpy as np
import pytest

from perfbench.lib import manifest, program_spans
from perfbench.lib.records import Records, Step, Tick
from perfbench.lib.trace import Slice
from perfbench.tests import smoke
from repro_torch.obs import profiling

T0 = 1000.0          # perf_counter seconds at the first mark
OFF = 5e5            # the slice's clock less perf_counter's, us


@pytest.fixture(autouse=True)
def empty_ring():
    profiling.reset()
    yield
    profiling.reset()


def _read(name, rec):
    return manifest.reader(name)(name, rec)


def _tick(t_len, start, end, **kw):
    return Tick(t_len, start, np.ones(2, np.int64), np.zeros(2, bool),
                end=end, **kw)


def _us(t):
    return 1e6 * t + OFF


def _slice(kernels, marks, name="step_enqueue", jitter=None):
    jitter = jitter or [0.0] * len(marks)
    spans = [(name, _us(m) + j, _us(m) + j + 10.0)
             for m, j in zip(marks, jitter)]
    lo = min(s for _, s, _ in spans)
    hi = max(_us(m) for m in marks) + 1e5
    return Slice(kernels, spans, lo, hi)


def test_the_clocks_pair_by_the_median_offset():
    ticks = [_tick(16, T0 + 0.1 * i, T0 + 0.1 * i + 0.09, in_slice=True)
             for i in range(5)]
    rec = Records(cell={}, config={}, window=(0, 1e4), ticks=ticks)
    rec.slice = _slice([], [t.start for t in ticks],
                       jitter=[3.0, 5.0, 4.0, 9.0, 4.0])
    assert program_spans.offset_us(rec) == pytest.approx(OFF + 4.0)
    # a tick more than the slice has spans: nothing read
    rec.ticks = ticks + [_tick(16, T0 + 1, T0 + 1.1, in_slice=True)]
    assert program_spans.offset_us(rec) is None
    # offsets that scatter over 50 us
    rec.ticks = ticks
    rec.slice = _slice([], [t.start for t in ticks],
                       jitter=[0.0, 0.0, 200.0, 400.0, 600.0])
    assert program_spans.offset_us(rec) is None
    # training pairs its steps with the harness's ``data`` spans
    steps = [Step(T0 + i, T0 + i + 0.9, 8, True, True, True)
             for i in range(3)]
    rec = Records(cell={}, config={}, window=(0, 1e4), steps=steps)
    rec.slice = _slice([], [s.start for s in steps], name="data",
                       jitter=[7.0, 8.0, 9.0])
    assert program_spans.offset_us(rec) == pytest.approx(OFF + 8.0)
    # one late stamp of three leaves the median and its spread
    rec.slice = _slice([], [s.start for s in steps], name="data",
                       jitter=[450.0, 8.0, 9.0])
    assert program_spans.offset_us(rec) == pytest.approx(OFF + 9.0)
    rec.slice = _slice([], [s.start for s in steps], name="data",
                       jitter=[0.0, 100.0, 250.0])
    assert program_spans.offset_us(rec) is None
    assert program_spans.offset_us(Records({}, {}, (0, 1))) is None


def test_queue_wait_p90_reads_the_requests_that_arrived_in_the_window():
    for i in range(10):              # waits of 10, 20, ..., 100 ms
        profiling.add("serving/request/queue", T0 + i, T0 + i + 0.01 *
                      (i + 1))
    profiling.add("serving/request/queue", T0 - 5, T0 + 9)
    profiling.add("serving/request/queue", T0 + 20, T0 + 29)
    rec = Records(cell={}, config={}, window=(T0, T0 + 10))
    # the p90 of 10..100 ms, interpolated: 91 ms
    assert _read("queue_wait_p90_ms.chat", rec) == pytest.approx(91.0)
    # a profiled slice from 4.5 s to 6.5 s holds up the waits of the
    # requests that arrived at 4 s (it ends at 4.05 s: kept), 5 and 6 s
    rec.ticks = [_tick(16, T0 + 4.2, T0 + 4.5),
                 _tick(16, T0 + 4.6, T0 + 5.0, profiled=True),
                 _tick(16, T0 + 5.0, T0 + 6.4, profiled=True),
                 _tick(16, T0 + 6.5, T0 + 6.8)]
    waits = [10.0 * (i + 1) for i in range(10) if i not in (5, 6)]
    assert _read("queue_wait_p90_ms.chat", rec) == pytest.approx(
        float(np.percentile(waits, 90)))
    profiling.reset()
    assert _read("queue_wait_p90_ms.chat", rec) is None


def test_launch_ms_is_the_mean_launch_of_the_unprofiled_window_ticks():
    ticks = [_tick(16, T0, T0 + 0.2, in_window=True),
             _tick(16, T0 + 0.2, T0 + 0.4, in_window=True),
             _tick(1, T0 + 0.4, T0 + 0.5, in_window=True),
             _tick(16, T0 + 0.5, T0 + 0.7, in_window=True, profiled=True),
             _tick(16, T0 + 0.7, T0 + 0.9)]
    for t, ms in zip(ticks, (10, 30, 2, 50, 70)):
        profiling.add("serving/launch", t.start + 0.001,
                      t.start + 0.001 + ms / 1e3)
    rec = Records(cell={}, config={}, window=(T0, T0 + 1), ticks=ticks)
    assert _read("launch_ms.t16.chat", rec) == pytest.approx(20.0)
    assert _read("launch_ms.t1.chat", rec) == pytest.approx(2.0)
    # a window tick without the span: nothing read
    rec.ticks = ticks + [_tick(16, T0 + 2, T0 + 2.2, in_window=True)]
    assert _read("launch_ms.t16.chat", rec) is None


def test_train_phase_ms_sums_the_busy_device_inside_each_phase():
    steps = [Step(T0 + i, T0 + i + 0.9, 8, True, True, True)
             for i in range(2)]
    steps.append(Step(T0 + 2, T0 + 2.9, 8, True, True, False))
    kernels = []
    for i, st in enumerate(steps):
        profiling.add("train/forward", st.start + 0.1, st.start + 0.3)
        profiling.add("train/backward", st.start + 0.3, st.start + 0.7)
        k = _us(st.start)
        kernels += [("f", k + 1.0e5, k + 2.0e5),   # 100 ms forward
                    ("f", k + 2.5e5, k + 3.5e5),   # half in forward
                    ("g", k + 4.0e5, k + 6.0e5)]   # 200 ms backward
    rec = Records(cell={}, config={}, window=(T0, T0 + 3), steps=steps)
    rec.slice = _slice(kernels, [s.start for s in steps[:2]], name="data")
    assert _read("train_phase_ms.forward.train", rec) == \
        pytest.approx(150.0)
    assert _read("train_phase_ms.backward.train", rec) == \
        pytest.approx(250.0)
    # a phase with no span in a step of the slice: nothing read
    assert _read("train_phase_ms.clip.train", rec) is None


def test_a_traced_chat_run_leaves_the_programs_spans():
    line = smoke.perform(smoke.CHAT, seed=2 ** 31 + 5, trace=True)
    assert line["correct"], line["checks"]
    names = [s.name for s in profiling.recorded()]
    ticks = names.count("serving/tick")
    assert ticks > 0 and names.count("serving/block_step") == ticks
    assert names.count("serving/request/queue") > 0
    assert line["metrics"]["queue_wait_p90_ms.chat"]["value"] >= 0
    # no graph replay on the CPU: the launch metrics are left out
    assert "launch_ms.t16.chat" not in line["metrics"]
