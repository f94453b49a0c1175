"""The metric arithmetic on hand-made records: whole-window percentiles, a
request without a token counted as failed, window rates, the idle share
from intervals, and the roofline and MFU formulas against a hand count."""
import math
import types

import numpy as np
import pytest

from perfbench.lib import frozen, manifest, stats
from perfbench.lib.records import Records, Step, Tick
from perfbench.lib.trace import Slice
from perfbench.runners import serve

# one Mamba-2 layer, small enough to count by hand
CFG = {"family": "ssm", "n_layers": 1, "d_model": 8, "vocab": 10,
       "ssm_state": 4, "ssm_head_dim": 4, "ssm_groups": 1, "expand": 2,
       "conv_kernel": 4, "norm_eps": 1e-5, "tie_embeddings": True,
       "costs": "costs_ssm",
       "reference": "reference_ssm"}
# d_inner 16, 4 SSM heads, conv channels 16 + 8 = 24, in_proj 2*16+8+4 = 44
LAYER_FLOPS = 2 * (8 * 44 + 16 * 8 + 4 * 24) + 2 * 2 * 4 * 4 * 4
HEAD_FLOPS = 2 * 10 * 8


def _read(name, rec):
    return manifest.reader(name)(name, rec)


def test_percentiles_are_over_the_whole_window():
    vals = list(range(1, 101))
    assert stats.percentile(vals, 90) == pytest.approx(90.1)
    # a mean of chunk percentiles would differ: one chunk of 1s, one of 100s
    vals = [1.0] * 50 + [100.0] * 50
    assert stats.percentile(vals, 95) == 100.0
    assert stats.percentile([], 90) is None


def test_serve_metrics_count_a_request_without_tokens_as_failed():
    q = types.SimpleNamespace
    due = [q(uid=0, arrival_s=1.0), q(uid=1, arrival_s=2.0),
           q(uid=2, arrival_s=3.0)]
    token_s = {0: [1.5, 1.6, 1.8], 1: [], 3: [0.5, 2.5]}
    out = serve.serve_metrics(due, token_s, ws=1.0, we=3.0)
    assert out["missing"] == [1, 2]
    # TTFT of the one request that had a token
    assert out["values"]["ttft_p90_ms"] == pytest.approx(500.0)
    # gaps whose later token came after the window opened: 100, 200, 2000
    assert out["values"]["itl_p95_ms"] == pytest.approx(
        float(np.percentile([100.0, 200.0, 2000.0], 95)))
    # 1.5, 1.6, 1.8 and 2.5 inside [1, 3], over 2 seconds
    assert out["values"]["serve_tok_s"] == pytest.approx(2.0)


def test_union_and_gaps_of_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (9, 12)]
    assert stats.union_seconds(iv, 0, 10) == pytest.approx(3 + 1 + 1)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 9)]


def _slice():
    kernels = [("rmsnorm_kernel<bf16>", 0.0, 10.0),
               ("rmsnorm_kernel<bf16>", 20.0, 30.0),
               ("sm90_xmma_gemm_bf16", 30.0, 60.0),
               ("vectorized_elementwise_kernel", 70.0, 80.0),
               ("piece_totals_kernel", 80.0, 90.0),
               ("ssd_scan_mma_kernel<bf16>", 90.0, 100.0)]
    spans = [("step_enqueue", 0.0, 5.0), ("sample_wait", 5.0, 64.0),
             ("scheduler", 64.0, 100.0)]
    return Slice(kernels, spans, 0.0, 100.0)


def test_slice_idle_share_and_its_gaps():
    s = _slice()
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(80e-6)
    rec = Records(cell={}, config=CFG, window=(0, 1), slice=s)
    assert _read("device_idle.x", rec) == pytest.approx(20.0)
    # the gaps 10-20 and 60-70 us, both while the host waited on a sample
    assert s.idle_gaps() == [["sample_wait", pytest.approx(10e-6)],
                             ["sample_wait", pytest.approx(10e-6)]]
    assert s.top_ops()[0] == ["sm90_xmma_gemm_bf16", pytest.approx(30e-6)]


def test_kinds_and_the_port_s_kernels():
    assert frozen.kind_of("piece_totals_kernel") == "reduce"
    assert frozen.kind_of("void rmsnorm_kernel<bf16, 2>") == "rmsnorm"
    assert frozen.kind_of("nvjet_tst_128x64") == "gemm"
    assert frozen.kind_of("elementwise_kernel") == "other"
    assert frozen.is_port_kernel("wscan_pass_kernel")
    assert not frozen.is_port_kernel("elementwise_kernel")


def _tick(t_len, start, end, n_valid, reset=None, **kw):
    n_valid = np.array(n_valid)
    return Tick(t_len, start, n_valid,
                np.zeros_like(n_valid) if reset is None else np.array(reset),
                end=end, **kw)


def test_serving_mfu_counts_valid_rows_by_hand():
    ticks = [_tick(4, 0.0, 1e-3, [3, 0], [1, 0], in_window=True),
             _tick(1, 1e-3, 3e-3, [1, 0], in_window=True),
             _tick(1, 3e-3, 4e-3, [1, 1], [0, 1], profiled=True,
                   in_window=True)]
    rec = Records(cell={"slots": 2}, config=CFG, window=(0, 1), ticks=ticks)
    flops = 3 * LAYER_FLOPS + HEAD_FLOPS + LAYER_FLOPS + HEAD_FLOPS
    assert _read("mfu.x", rec) == pytest.approx(
        100 * flops / (3e-3 * frozen.PEAK_FLOPS_BF16))


def test_train_mfu_by_hand():
    steps = [Step(0.0, 2.0, 64, True), Step(2.0, 4.0, 64, True, True)]
    rec = Records(cell={"batch": 2}, config=CFG, window=(0, 4), steps=steps)
    flops = 3 * 64 * (LAYER_FLOPS + HEAD_FLOPS)
    assert _read("mfu.x", rec) == pytest.approx(
        100 * flops / (2.0 * frozen.PEAK_FLOPS_BF16))


def test_rmsnorm_roofline_by_hand():
    # one T = 4 tick of 2 slots in the slice: the layer's outer (8 rows x
    # 8) and gated (8 x 16) norms, then the final norm (2 x 8)
    ticks = [_tick(4, 0.0, 1.0, [4, 4], in_slice=True)]
    kernels = [("rmsnorm_kernel", 0.0, 1.0)] * 3
    rec = Records(cell={"slots": 2}, config=CFG, window=(0, 1), ticks=ticks,
                  slice=Slice(kernels, [("step_enqueue", 0.0, 0.5)], 0.0,
                              3.0))
    nbytes = [(2 * 8 * 8 + 8) * 2, (2 * 8 * 16 + 16) * 2, (2 * 2 * 8 + 8) * 2]
    bound = sum(b / frozen.HBM_BW for b in nbytes) / 3
    assert _read("rmsnorm_roofline.t4.x", rec) == pytest.approx(
        100 * bound / 1e-6)
    # no step of that T in the slice: nothing to read
    assert _read("rmsnorm_roofline.t1.x", rec) is None
    # a count that strays from the calls the steps make reads nothing
    rec.slice.kernels = kernels[:1]
    assert _read("rmsnorm_roofline.t4.x", rec) is None


def test_rmsnorm_roofline_reads_only_the_steps_of_its_t():
    # a T = 4 step's three norms at 1 us each, then a T = 1 step's three at
    # 5 us each: each T reads its own step's kernels
    ticks = [_tick(4, 0.0, 1.0, [4, 4], in_slice=True),
             _tick(1, 1.0, 2.0, [1, 1], in_slice=True)]
    kernels = [("rmsnorm_kernel", 10.0, 11.0)] * 3 + \
        [("rmsnorm_kernel", 30.0, 35.0)] * 3
    spans = [("step_enqueue", 0.0, 5.0), ("sample_wait", 5.0, 20.0),
             ("step_enqueue", 20.0, 25.0)]
    rec = Records(cell={"slots": 2}, config=CFG, window=(0, 2), ticks=ticks,
                  slice=Slice(kernels, spans, 0.0, 40.0))
    for t_len, us in ((4, 1.0), (1, 5.0)):
        calls = [(2 * t_len, 8), (2 * t_len, 16), (2, 8)]
        bound = sum((2 * r * w + w) * 2 / frozen.HBM_BW
                    for r, w in calls) / 3
        assert _read(f"rmsnorm_roofline.t{t_len}.x", rec) == pytest.approx(
            100 * bound / (us * 1e-6))


def test_ssd_and_reduce_rooflines_by_hand():
    steps = [Step(0.0, 1.0, 64, True, True, True)]
    rec = Records(cell={"batch": 2}, config=CFG, window=(0, 1), steps=steps,
                  slice=_slice())
    # the SSD call over (2, 32): 4 heads of 4, state 4, one chunk of 64
    tri = 64 * 65 // 2
    flops = 2 * 4 * 1 * 2 * (tri * 4 + tri * 4 + 2 * 64 * 4 * 4)
    nbytes = 64 * 16 * 2 * 2 + 64 * 8 * 2 + 64 * 4 * 4 * 2 + 2 * 64 * 4
    bound = max(flops / frozen.PEAK_FLOPS_BF16, nbytes / frozen.HBM_BW)
    assert _read("ssd_roofline.x", rec) == pytest.approx(100 * bound / 10e-6)
    specs = manifest.reference(CFG).param_specs(CFG)
    numels = [math.prod(s.shape) for s in _flat(specs)]
    bound = sum((n + 1) * 4 / frozen.HBM_BW for n in numels)
    assert _read("reduce_roofline.x", rec) == pytest.approx(
        100 * bound / 10e-6)
    # torch's elementwise kernel is "other"; cuBLAS and csrc's are not
    assert _read("other_device_ms.x", rec) == pytest.approx(10e-3)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [tree]


def test_tick_times_rows_and_scheduler_time():
    ticks = [_tick(16, 0.0, 0.1, [16, 3], in_window=True),
             _tick(16, 0.1, 0.3, [16, 0], in_window=True, profiled=True),
             _tick(1, 0.3, 0.31, [1, 1], in_window=True),
             _tick(1, 0.31, 0.33, [1, 0])]
    rec = Records(cell={"slots": 2}, config=CFG, window=(0, 1), ticks=ticks,
                  phases={"admission": 0.002, "bookkeep": 0.004, "ticks": 3})
    assert _read("tick_ms.t16.x", rec) == pytest.approx(100.0)
    assert _read("tick_ms.t1.x", rec) == pytest.approx(10.0)
    assert _read("tick_ms.t4.x", rec) is None
    assert _read("valid_row_share.x", rec) == pytest.approx(
        100 * (19 + 16 + 2) / (32 + 32 + 2))
    assert _read("sched_host_ms.x", rec) == pytest.approx(2.0)
