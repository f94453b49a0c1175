"""Parity of the PyTorch port's observability (``repro_torch.obs``) with the
JAX package's ``repro.obs``.

The reference's unit tests (``tests/test_obs.py``: off by default, nesting,
metrics math, histogram edges, the event ring, the JSON-lines round trip,
the CLI scope) ported one for one; one sequence of metric operations
through both registries with identical snapshots and exposition text; the
port's resolution events against the reference's ``KernelPolicy.resolve``
at two sizes and two dtypes; and the port's continuous engine against the
reference's on llama and mamba SMOKE, ring and paged, in f32 with the
reference's weights carried over by ``params_from_numpy``: the ``serving``
and ``kv_*`` event sequences, the request, token and deferral counters, the
histogram counts per label, the final gauges, and the resolution and
``kernel_invoke`` events as sets (the reference records them once per jit
trace, the port on the CPU at every eager tick). Then the port's own spans
(``obs.profiling``), which the reference has no counterpart of: off unless
a session or a profiler records, waiting for the device only under a
profiler, the ring's bound, the tick and queue spans, and the train
step's.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.configs import llama3_2_1b as jllama
from repro.configs import mamba2_1_3b as jmamba
from repro.core import dispatch as jdispatch
from repro.core.policy import KernelPolicy
from repro.models import build as jbuild
from repro.models.common import init_params
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import engine as jengine
from repro_torch import obs
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.configs import mamba2_1_3b as tmamba
from repro_torch.core import autotune as tautotune
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import policy as tpolicy
from repro_torch.kernels import ops as tkops
from repro_torch.launch import serve as tserve
from repro_torch.models import build_lm
from repro_torch.models.common import params_from_numpy
from repro_torch.obs import cli as obs_cli
from repro_torch.obs import profiling
from repro_torch.obs.events import RESOLUTION_FIELDS, EventSink
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.parallel.sharded_state import StepClock
from repro_torch.serving import Request, ServeConfig, ServingEngine

ARCHS = {"llama": (jllama, tllama), "mamba": (jmamba, tmamba)}


def resolve_on_cpu(op, **kw):
    return tpolicy.get_policy().resolve(op=op, device=torch.device("cpu"),
                                        **kw)


# ---------------------------------------------------------------------------
# off by default


def test_disabled_by_default():
    assert obs.active() is None
    resolve_on_cpu("reduce", n=1024, dtype=torch.float32)  # no record
    with obs.using_obs() as sess:
        assert sess.events.emitted == 0          # nothing retroactive
    assert obs.active() is None                  # scope restored


def test_resolve_emits_only_inside_scope():
    with obs.using_obs() as sess:
        resolve_on_cpu("reduce", n=1024, dtype=torch.float32)
        n_inside = sess.events.emitted
    resolve_on_cpu("reduce", n=1024, dtype=torch.float32)  # after
    assert n_inside == 1
    assert sess.events.emitted == n_inside


def test_using_obs_restores_previous_session():
    with obs.using_obs() as outer:
        with obs.using_obs() as inner:
            assert obs.active() is inner
        assert obs.active() is outer
    assert obs.active() is None


def test_enable_disable_leave_the_session_readable():
    sess = obs.enable()
    try:
        assert obs.active() is sess
        assert obs.emit("custom", a=1)["a"] == 1
    finally:
        obs.disable()
    assert obs.active() is None
    assert obs.emit("custom", a=2) is None       # no-op when disabled
    assert [e["a"] for e in sess.events.events("custom")] == [1]


# ---------------------------------------------------------------------------
# metrics math


def test_counter_and_gauge():
    reg = MetricsRegistry()
    c = reg.counter("c", "help")
    c.inc()
    c.inc(2, op="reduce")
    assert c.value() == 1
    assert c.value(op="reduce") == 2
    with pytest.raises(ValueError):
        c.inc(-1)
    g = reg.gauge("g")
    g.set(3.5)
    g.set(7, slot="1")
    assert g.value() == 3.5
    assert g.value(slot="1") == 7.0


def test_metric_kind_mismatch_raises():
    reg = MetricsRegistry()
    reg.counter("m")
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("m")


def test_histogram_bucket_math():
    reg = MetricsRegistry()
    h = reg.histogram("h", "lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 1.0, 2.0):      # 1.0 lands in le=1.0 (<= edge)
        h.observe(v)
    st = h.stats()
    assert st["count"] == 4
    assert st["sum"] == pytest.approx(3.55)
    assert st["counts"] == [1, 2, 1]     # per-bucket + the +Inf bucket
    txt = reg.prometheus_text()
    assert 'h_bucket{le="0.1"} 1' in txt
    assert 'h_bucket{le="1"} 3' in txt            # cumulative
    assert 'h_bucket{le="+Inf"} 4' in txt
    assert "h_sum 3.55" in txt
    assert "h_count 4" in txt


def test_histogram_rejects_bad_edges():
    reg = MetricsRegistry()
    with pytest.raises(ValueError):
        reg.histogram("empty", buckets=())
    with pytest.raises(ValueError):
        reg.histogram("dupe", buckets=(1.0, 1.0))


def test_snapshot_shape():
    reg = MetricsRegistry()
    reg.counter("c").inc(op="x")
    snap = reg.snapshot()
    assert snap["c"]["kind"] == "counter"
    assert snap["c"]["series"] == [{"labels": {"op": "x"}, "value": 1}]
    json.dumps(snap)                      # JSON-lines exporter contract


def drive(reg) -> None:
    """One sequence of counter, gauge and histogram operations."""
    c = reg.counter("repro_x_total", "x by op")
    c.inc()
    c.inc(2.5, op="scan")
    c.inc(op="scan")
    reg.counter("repro_x_total").inc(3, op="reduce")
    g = reg.gauge("repro_g", "a gauge")
    g.set(7)
    g.set(0.125, slot="1")
    g.set(3, slot="1")
    h = reg.histogram("repro_h_seconds", "latency")
    for i, v in enumerate((0.0, 1e-4, 2.4e-3, 0.1, 0.3, 9.99, 10.0, 12.0,
                           1e6)):
        h.observe(v, phase=("decode" if i % 2 else "prefill"))
    hb = reg.histogram("repro_hb", "custom edges", buckets=(5, 0.5, 2))
    for v in (0.5, 0.6, 2, 100):
        hb.observe(v)
    reg.counter("repro_empty_help")


def test_registry_matches_the_reference():
    """The same operations through the reference's registry and the port's
    give identical snapshots and Prometheus text: names, help strings,
    label order, bucket edges (Prometheus ``le``), value rendering."""
    ours, theirs = MetricsRegistry(), JMetricsRegistry()
    drive(ours)
    drive(theirs)
    assert ours.snapshot() == theirs.snapshot()
    assert ours.prometheus_text() == theirs.prometheus_text()
    assert ours.names() == theirs.names()
    assert obs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    assert obs.RESOLUTION_FIELDS == jobs.RESOLUTION_FIELDS
    assert obs.DEFAULT_RING == jobs.DEFAULT_RING


# ---------------------------------------------------------------------------
# event sink


def test_event_ring_bounded():
    sink = EventSink(ring=3)
    for i in range(10):
        sink.emit("k", i=i)
    assert sink.emitted == 10
    assert [e["i"] for e in sink.events()] == [7, 8, 9]
    with pytest.raises(ValueError):
        EventSink(ring=0)


def test_jsonl_tee_roundtrip(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    with obs.using_obs(events_path=path) as sess:
        sess.emit("custom", value=1, arr=np.int32(7))  # stringified, not lost
    evs = obs.load_jsonl(path)
    assert len(evs) == 1
    assert evs[0]["kind"] == "custom" and evs[0]["value"] == 1
    assert "ts" in evs[0]


def test_jsonl_lines_match_the_reference(tmp_path):
    """Both sinks write the same line for the same event, ``ts`` aside."""
    lines = {}
    for name, sink_cls in (("port", EventSink),
                           ("ref", jobs.EventSink)):
        path = tmp_path / f"{name}.jsonl"
        sink = sink_cls(jsonl_path=str(path))
        sink.emit("custom", value=1, arr=np.int32(7), t=torch.float32,
                  nested={"a": [1, 2]})
        sink.close()
        ev = json.loads(path.read_text())
        ev.pop("ts")
        lines[name] = ev
    assert lines["port"]["t"] == "torch.float32"
    lines["port"].pop("t")
    lines["ref"].pop("t")
    assert lines["port"] == lines["ref"]


def test_format_resolution_tolerates_partial():
    line = obs.format_resolution({"op": "reduce", "chosen_path": "fused"})
    assert "op=reduce" in line and "path=fused" in line
    assert "n=-" in line and "src=-" in line
    full = {"op": "scan", "n": 2048, "shard_n": 512, "shard_divisor": 4,
            "dtype": "f32", "band": 11, "backend": "cpu",
            "level": "dispatch", "chosen_path": "baseline",
            "tuning": {"block_s": 64}, "table_src": "heuristic"}
    line = obs.format_resolution(full)
    assert "shard_divisor=4(shard_n=512)" in line
    assert "tuning=block_s=64" in line
    assert line == jobs.format_resolution(full)


# ---------------------------------------------------------------------------
# resolution events


OPS = (("reduce", "dispatch"), ("scan", "dispatch"),
       ("weighted_scan", "dispatch"), ("attention", "dispatch"),
       ("ssd", "dispatch"), ("rmsnorm", "kernel"),
       ("segmented_reduce", "kernel"), ("segmented_scan", "kernel"),
       ("ssd_scan", "kernel"))
SHARED = ("op", "n", "shard_n", "dtype", "band", "level")


def src_kind(src: str) -> str:
    """The category of a ``table_src``: a table's path reads ``table``."""
    return src if src in ("none", "static", "heuristic") else "table"


@pytest.mark.parametrize("n", [16, 1 << 22])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resolution_event_matches_the_reference(n, dtype):
    """With both packages on one table file (the port's checked-in one), for
    each op the port's event on a CPU tensor has the reference's keys in
    order, the same op, sizes, dtype tag, band (clamped at the reference's
    MAX_BAND), level, chosen path and ``table_src`` category (the table's
    bucket at n = 16, the heuristic past the table's bands). ``tuning`` is
    not compared: the reference's is TPU geometry, and the plain versions
    take no knob."""
    table = str(tautotune.DEFAULT_TABLE_PATH)
    jpol = KernelPolicy(autotune_table=table, interpret_fallback="silent")
    tpol = tpolicy.KernelPolicy(autotune_table=table,
                                interpret_fallback="silent")
    for op, level in OPS:
        with jobs.using_obs() as jsess:
            jpol.resolve(op=op, n=n, dtype=getattr(jnp, dtype), level=level)
        with obs.using_obs() as sess:
            got = tpol.resolve(op=op, n=n, dtype=getattr(torch, dtype),
                               level=level, device=torch.device("cpu"))
        (want,), (ev,) = (jsess.events.events("resolution"),
                          sess.events.events("resolution"))
        assert list(ev) == list(want)
        assert list(ev)[2:] == list(RESOLUTION_FIELDS)
        assert {k: ev[k] for k in SHARED} == {k: want[k] for k in SHARED}
        assert ev["chosen_path"] == got == want["chosen_path"]
        assert src_kind(ev["table_src"]) == src_kind(want["table_src"])
        assert (ev["shard_divisor"], ev["explicit"], ev["backend"]) == \
            (want["shard_divisor"], want["explicit"], want["backend"])
        if src_kind(ev["table_src"]) == "table":
            assert ev["table_src"] == want["table_src"] == table
        counter = sess.metrics.get("repro_resolutions_total")
        assert counter.value(op=op, path=str(got), level=level) == 1
        assert counter.help == jsess.metrics.get(
            "repro_resolutions_total").help


def test_resolution_tags_match_the_reference():
    from repro.core import autotune

    for n in (0, 1, 15, 16, 17, 1 << 20, 1 << 21, 1 << 40):
        assert tautotune.band(n) == autotune.band(n)
    for t, j in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                 (torch.float16, jnp.float16), (torch.int32, jnp.int32),
                 (None, None)):
        assert tautotune.dtype_tag(t) == autotune.dtype_tag(j)
    assert tautotune.MAX_BAND == autotune.MAX_BAND
    assert tautotune.current_backend(torch.device("cpu")) == "cpu"
    assert tautotune.current_backend("cuda:0") == "gpu"


def small_inputs(op: str, rng):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    if op in ("reduce", "scan"):
        return (f(3, 40),)
    if op == "weighted_scan":
        return f(3, 40), -np.abs(f(3, 40))
    if op == "attention":
        return f(2, 24, 4, 16), f(2, 24, 2, 16), f(2, 24, 2, 16)
    return (f(1, 24, 4, 8), np.abs(f(1, 24, 4)), -np.abs(f(4)),
            f(1, 24, 1, 8), f(1, 24, 1, 8))


@pytest.mark.parametrize("op", ["reduce", "scan", "weighted_scan",
                                "attention", "ssd"])
def test_dispatch_resolutions_match_the_reference(op):
    """Each op of ``core.dispatch`` under ``tile`` on a CPU tensor records
    the resolutions the reference records under ``interpret`` (same op, n,
    dtype, band, chosen path): the dispatch level's, then the registry's
    second, kernel-level one (the registry's name, the path as its per-call
    label), and one ``kernel_invoke`` on ``interpret`` with no knob (the
    plain version takes none)."""
    ins = small_inputs(op, np.random.default_rng(0))
    with jobs.using_obs() as jsess:
        getattr(jdispatch, op)(*map(jnp.asarray, ins), policy="interpret")
    with obs.using_obs() as sess:
        getattr(tdispatch, op)(*map(torch.from_numpy, ins), policy="tile")
    want = jsess.events.events("resolution")
    got = sess.events.events("resolution")
    assert [tuple(e[k] for k in SHARED) for e in got] == \
        [tuple(e[k] for k in SHARED) for e in want]
    assert [e["explicit"] for e in got] == [None, "interpret"]
    assert [e["explicit"] for e in want] == [None, "interpret"]
    assert [e["chosen_path"] for e in got] == \
        [e["chosen_path"] for e in want] == ["interpret", "interpret"]
    keys = ("op", "n", "dtype", "path")
    invokes = sess.events.events("kernel_invoke")
    assert [tuple(e[k] for k in keys) for e in invokes] == \
        [tuple(e[k] for k in keys)
         for e in jsess.events.events("kernel_invoke")]
    assert [e["tuning"] for e in invokes] == [{}]
    assert sess.metrics.get("repro_kernel_invocations_total").value(
        op=got[1]["op"], path="interpret") == 1


def test_logdepth_wrappers_name_their_path():
    x = torch.randn(2, 64)
    with obs.using_obs() as sess:
        tdispatch.scan(x, policy="tile_logdepth")
        tdispatch.weighted_scan(x, -x.abs(), policy="tile_logdepth")
    inv = [(e["op"], e["n"], e["path"])
           for e in sess.events.events("kernel_invoke")]
    assert inv == [("segmented_scan", 64, "tile_logdepth"),
                   ("weighted_scan", 64, "tile_logdepth")]


def test_fused_and_baseline_paths_invoke_no_kernel():
    """The dispatch level's fused and baseline forms invoke nothing; RMSNorm
    lives in the reference's kernel registry, whose ``fused`` (the plain
    version) still records one invocation on ``fused``, as the reference's
    ``pallas_op`` does."""
    x = torch.randn(2, 32)
    with obs.using_obs() as sess:
        tdispatch.reduce(x, policy="fused")
        tdispatch.scan(x, policy="baseline")
        tdispatch.rmsnorm(x, torch.ones(32), policy="fused")
    from repro.kernels import ops as jkops

    jx = jnp.asarray(x.numpy())
    with jobs.using_obs() as jsess:
        jdispatch.reduce(jx, policy="fused")
        jdispatch.scan(jx, policy="baseline")
        jkops.rmsnorm(jx, jnp.ones(32), policy="fused")
    keys = ("op", "n", "dtype", "path")
    assert [tuple(e[k] for k in keys)
            for e in sess.events.events("kernel_invoke")] == \
        [tuple(e[k] for k in keys)
         for e in jsess.events.events("kernel_invoke")] == \
        [("rmsnorm", 32, "f32", "fused")]
    assert [(e["op"], e["level"], e["chosen_path"])
            for e in sess.events.events("resolution")] == [
        ("reduce", "dispatch", "fused"), ("scan", "dispatch", "baseline"),
        ("rmsnorm", "kernel", "fused")]


# ---------------------------------------------------------------------------
# the serving engine against the reference's


def reference(jmod):
    cfg = dataclasses.replace(jmod.SMOKE, policy="fused")
    bundle = jbuild(cfg)
    params = init_params(jax.random.PRNGKey(0), bundle.params_pspec,
                         cfg.dtype)
    return bundle, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def weights():
    """The reference's bundle, params and numpy params, per arch."""
    return {name: reference(jmod) for name, (jmod, _) in ARCHS.items()}


def port_engine(np_params, tmod, **cfg_kw) -> ServingEngine:
    cfg = tmod.SMOKE
    return ServingEngine(build_lm(cfg), params_from_numpy(
        np_params, cfg, device="cpu"), ServeConfig(**cfg_kw))


def workload():
    """Four requests on a shared 20-token prefix and two of their own
    (uid, prompt, budget)."""
    rng = np.random.default_rng(4)
    prefix = rng.integers(3, 256, size=20, dtype=np.int32)
    reqs = [(i, np.concatenate([prefix, rng.integers(
        3, 256, size=3 + i, dtype=np.int32)]), 4) for i in range(4)]
    reqs += [(4 + i, rng.integers(3, 256, size=n, dtype=np.int32), 5)
             for i, n in enumerate((9, 27))]
    return reqs


KINDS = {"ring": {},
         # a pool of 7 pages of 8 rows for two slots of 4 pages: admissions
         # defer, trie entries are evicted, shared prefixes copy on write
         "paged": {"cache_kind": "paged", "page_rows": 8, "pool_pages": 7}}


def strip(events: list[dict]) -> list[dict]:
    return [{k: v for k, v in e.items() if k != "ts"} for e in events]


def series(sess, name: str, field: str = "value") -> dict:
    m = sess.metrics.get(name)
    if m is None:
        return {}
    return {k: (v if field == "value" else v[field])
            for k, v in m.series().items()}


HISTOGRAMS = ("repro_serving_ttft_seconds",
              "repro_serving_token_latency_seconds",
              "repro_serving_tick_phase_seconds", "repro_serving_tick_seconds")
COUNTERS = ("repro_serving_requests_total", "repro_serving_tokens_total",
            "repro_kvpool_defer_total", "repro_kvpool_cow_total",
            "repro_serve_block_traces_total",
            "repro_serving_compile_cache_total")
GAUGES = ("repro_serving_queue_depth", "repro_serving_slot_occupancy",
          "repro_kvpool_pages", "repro_kvpool_share_ratio",
          "repro_kvpool_cow_copies", "repro_kvpool_peak_pages_in_use")


def serve_both(ref, tmod, kind: str):
    """The workload through the reference's continuous engine and the
    port's, each under its own obs session: (reference results, port
    results, reference session, port session, port engine)."""
    jb, jp, npp = ref
    kw = dict(slots=2, max_new=5, eos_token=-1, prefill_chunk=8,
              **KINDS[kind])
    jengine.clear_compile_cache()        # one retrace per step shape
    with jobs.using_obs() as jsess:
        jeng = JServingEngine(jb, jp, JServeConfig(
            scheduler="continuous", policy="fused", **kw))
        want = jeng.run([JRequest(uid=u, prompt=p, max_new=m)
                         for u, p, m in workload()])
    with obs.using_obs() as sess:
        eng = port_engine(npp, tmod, **kw)
        got = eng.run([Request(uid=u, prompt=p, max_new=m)
                       for u, p, m in workload()])
    return want, got, jsess, sess, eng


@pytest.mark.parametrize("kind", ["ring", "paged"])
@pytest.mark.parametrize("arch", ["llama", "mamba"])
def test_serving_obs_matches_the_reference(weights, arch, kind):
    want, got, jsess, sess, eng = serve_both(weights[arch], ARCHS[arch][1],
                                             kind)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    for ev in ("serving", "kv_alloc", "kv_cow", "kv_evict", "kv_defer",
               "serve_block_trace"):
        assert strip(sess.events.events(ev)) == \
            strip(jsess.events.events(ev)), ev
    for name in COUNTERS + GAUGES:
        assert series(sess, name) == series(jsess, name), name
        if sess.metrics.get(name) is not None:
            assert sess.metrics.get(name).help == \
                jsess.metrics.get(name).help
    for name in HISTOGRAMS:
        assert series(sess, name, "count") == \
            series(jsess, name, "count"), name
        assert sess.metrics.get(name).buckets == \
            jsess.metrics.get(name).buckets
    # resolution and kernel_invoke: the reference once per jit trace, the
    # port at every eager tick on the CPU; the same calls all the same
    def calls(s, kind_, keys):
        return {tuple(e[k] for k in keys) for e in s.events.events(kind_)}

    res = ("op", "n", "dtype", "level")
    assert calls(sess, "resolution", res) == calls(jsess, "resolution", res)
    inv = ("op", "n", "dtype")
    assert calls(sess, "kernel_invoke", inv) == \
        calls(jsess, "kernel_invoke", inv)
    n_tok = sum(len(r.tokens) for r in got)
    assert series(sess, "repro_serving_tokens_total") == {(): n_tok}
    assert series(sess, "repro_serving_ttft_seconds", "count") == \
        {(): len(got)}
    # one step-cache lookup per engine; one retrace per (T, capacity)
    assert series(sess, "repro_serving_compile_cache_total") == \
        {(("result", "miss"),): 1}
    assert len(sess.events.events("serve_block_trace")) == \
        len(eng._step_shapes) == 2
    if kind == "paged":
        kv = eng.kv_stats()
        assert len(sess.events.events("kv_cow")) == kv["cow_copies"]
        assert len(sess.events.events("kv_defer")) == kv["defers"]
        if arch == "llama":
            assert kv["cow_copies"] > 0 and kv["defers"] > 0
            assert sess.events.events("kv_evict")
            assert series(sess, "repro_kvpool_peak_pages_in_use") == \
                {(): kv["peak_pages_in_use"]}


@pytest.fixture(scope="module")
def llama_port(weights):
    return weights["llama"][2]


def requests(n: int, vocab: int = 256) -> list[Request]:
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(
        3, vocab, size=int(rng.integers(4, 12)), dtype=np.int32))
        for i in range(n)]


def test_serving_tick_phases_sum_to_tick(llama_port):
    eng = port_engine(llama_port, tllama, slots=2, max_new=4, eos_token=-1)
    with obs.using_obs() as sess:
        eng.run(requests(3))
        ph = sess.metrics.get("repro_serving_tick_phase_seconds")
        tick = sess.metrics.get("repro_serving_tick_seconds")
    phase_sum = 0.0
    phases = set()
    for key, val in ph.series().items():
        phase_sum += val["sum"]
        phases.add(dict(key)["phase"])
    tick_stats = tick.stats()
    # the four phase intervals share their endpoints, so they sum to the
    # tick wall time up to float addition error
    assert phase_sum == pytest.approx(tick_stats["sum"], rel=1e-6)
    assert abs(phase_sum - tick_stats["sum"]) <= 1e-6 * tick_stats["count"]
    assert {"admission", "sample", "bookkeep"} <= phases
    assert phases & {"prefill", "decode"}
    counts = {dict(k)["phase"]: v["count"] for k, v in ph.series().items()}
    assert counts["admission"] == tick_stats["count"] == eng.ticks


def test_serving_events_and_compile_cache(llama_port):
    with obs.using_obs() as sess:
        eng = port_engine(llama_port, tllama, slots=2, max_new=3,
                          eos_token=-1)
        eng.run(requests(2))
        serving = sess.events.events("serving")
        cache = sess.metrics.get("repro_serving_compile_cache_total")
        ttft = sess.metrics.get("repro_serving_ttft_seconds")
    kinds = {e["event"] for e in serving}
    assert "admit" in kinds and "finish" in kinds
    assert cache.series() == {(("result", "miss"),): 1}
    assert ttft is not None and ttft.stats()["count"] >= 1


def test_session_opened_mid_tick_records_from_the_next_tick(llama_port):
    """The engine reads the session once a tick, at its start, as the
    reference does: a session opened inside tick 2's step records ticks 3
    on, and tick 2 finishes without it."""
    eng = port_engine(llama_port, tllama, slots=2, max_new=4, eos_token=-1)
    sessions = []
    step = eng._block_step

    def opening(inputs):
        if eng.ticks == 2:
            sessions.append(obs.enable())
        return step(inputs)

    eng._block_step = opening
    try:
        eng.run(requests(2))
    finally:
        obs.disable()
    (sess,) = sessions
    assert sess.metrics.get("repro_serving_tick_seconds").stats()[
        "count"] == eng.ticks - 3


def test_obs_off_changes_nothing(llama_port, monkeypatch):
    """With no session the engine touches no instrument: the same tokens
    and launch counts as a run with a session, and no emit, metric or span
    call at all."""
    runs = []
    for on in (False, True, False):
        eng = port_engine(llama_port, tllama, slots=2, max_new=4,
                          eos_token=-1, **KINDS["paged"])
        tkops.reset_launches()
        with monkeypatch.context() as m:
            if not on:
                def untouched(*a, **k):
                    raise AssertionError("obs touched with no session")
                m.setattr(EventSink, "emit", untouched)
                m.setattr(MetricsRegistry, "_get", untouched)
                m.setattr(torch.profiler, "record_function", untouched)
            with obs.using_obs() if on else _null():
                res = eng.run([Request(uid=u, prompt=p, max_new=n)
                               for u, p, n in workload()])
        runs.append(([r.tokens for r in res], tkops.launch_counts(),
                     eng.kv_stats(), eng.trace))
    assert runs[0] == runs[1] == runs[2]


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


# ---------------------------------------------------------------------------
# CLI scope and the serve launcher


def test_obs_scope_noop_without_flags():
    args = argparse.Namespace(obs_events=None, metrics_out=None,
                              profile_dir=None)
    with obs_cli.obs_scope(args) as sess:
        assert sess is None
        assert obs.active() is None


def test_obs_scope_writes_artifacts(tmp_path):
    ev = str(tmp_path / "e.jsonl")
    prom = str(tmp_path / "m.prom")
    args = argparse.Namespace(obs_events=ev, metrics_out=prom,
                              profile_dir=None)
    with obs_cli.obs_scope(args) as sess:
        sess.counter("repro_test_total", "x").inc()
        sess.emit("custom", a=1)
    assert obs.active() is None
    assert obs.load_jsonl(ev)[0]["a"] == 1
    assert "repro_test_total 1" in open(prom).read()


def test_obs_flags_match_the_reference():
    from repro.obs import cli as jcli

    helps = []
    for mod in (obs_cli, jcli):
        ap = argparse.ArgumentParser()
        mod.add_obs_args(ap)
        helps.append({a.dest: (a.option_strings, a.default, a.metavar)
                      for a in ap._actions if a.dest != "help"})
    assert helps[0] == helps[1]


def test_span_is_free_unless_tracing(tmp_path, monkeypatch):
    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", None)
    with obs.span("serving/block_step"):      # no trace: never looked up
        pass
    with obs.tracing(None):
        with obs.span("serving/block_step"):
            pass
    assert obs.span("serving/launch") is profiling.OFF
    assert not profiling.recording()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_span_records_under_a_session_without_the_profiler(monkeypatch):
    """A session alone turns spans on: they nest by the thread's open
    span and go into the ring, and no ``record_function`` is opened."""
    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", None)
    with obs.using_obs():
        with obs.span("outer") as outer:
            with obs.span("inner"):
                pass
            profiling.add("late", outer.start - 1.0, outer.start)
    inner, late, outer_rec = profiling.recorded()
    assert [r.name for r in (inner, late, outer_rec)] == \
        ["inner", "late", "outer"]
    assert inner.parent == outer_rec.id == late.parent
    assert outer_rec.parent == 0 and late.id not in (inner.id, outer_rec.id)
    assert late.end == outer_rec.start
    assert outer_rec.start <= inner.start <= inner.end <= outer_rec.end


def test_spans_wait_for_the_device_only_under_a_profiler(monkeypatch):
    """``wait=`` waits for the device at a span's two ends while a
    profiler records, and never under a session alone."""
    from torch.profiler import ProfilerActivity, profile

    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", waits.append)
    card = torch.device("cuda", 0)
    profiling.reset()
    with obs.using_obs():
        with obs.span("train/update", wait=card):
            pass
    assert waits == [] and len(profiling.recorded()) == 1
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("train/update", wait=card):
            pass
        with obs.span("train/step"):
            pass
    assert waits == [card, card] and len(profiling.recorded()) == 3


def test_span_ring_drops_the_oldest_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 4)
    profiling.reset()
    try:
        with obs.using_obs():
            for i in range(6):
                with obs.span(f"s{i}"):
                    pass
        assert [r.name for r in profiling.recorded()] == \
            ["s2", "s3", "s4", "s5"]
        assert profiling.dropped() == 2
    finally:
        monkeypatch.undo()
        profiling.reset()
    assert profiling.recorded() == [] and profiling.dropped() == 0


def test_span_ring_loses_no_count_under_threads(monkeypatch):
    """Threads that record at once: the ring keeps its newest spans, each
    with its own id, and counts every other one as dropped."""
    monkeypatch.setattr(profiling, "RING", 100)
    profiling.reset()
    n_threads, each = (os.cpu_count() or 1) + 2, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                profiling.add("x", 0.0, 1.0)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        recs = profiling.recorded()
        assert len(recs) == len({r.id for r in recs}) == 100
        assert profiling.dropped() == n_threads * each - 100
    finally:
        sys.setswitchinterval(interval)
        monkeypatch.undo()
        profiling.reset()


def test_step_clock_parts_are_spans():
    """The sharded step's clock records each part as a
    ``<prefix>/<part>`` span and keeps its seconds as before."""
    profiling.reset()
    clock = StepClock(torch.device("cpu"), "train/sharded")
    with clock("update"):                     # nothing records
        pass
    assert profiling.recorded() == []
    with obs.using_obs():
        with clock("forward_backward"):
            with clock("gather"):
                pass
    gather, fb = profiling.recorded()
    assert (gather.name, fb.name) == ("train/sharded/gather",
                                      "train/sharded/forward_backward")
    assert gather.parent == fb.id
    assert set(clock.seconds) == {"update", "forward_backward", "gather"}
    assert clock.seconds["forward_backward"] >= clock.seconds["gather"]


def test_tick_spans_hold_the_block_step(llama_port):
    """Under a session every tick records one ``serving/tick`` span, after
    the tick's admission and before the next tick, holding that tick's
    ``serving/block_step``; the phase histograms are fed as before."""
    profiling.reset()
    eng = port_engine(llama_port, tllama, slots=2, max_new=4, eos_token=-1,
                      prefill_chunk=4)
    with obs.using_obs() as sess:
        eng.run(requests(3))
        ph = sess.metrics.get("repro_serving_tick_phase_seconds")
        tick_h = sess.metrics.get("repro_serving_tick_seconds")
    recs = profiling.recorded()
    ticks = [r for r in recs if r.name == "serving/tick"]
    steps = [r for r in recs if r.name == "serving/block_step"]
    assert len(ticks) == len(steps) == eng.ticks
    for t, step in zip(ticks, steps):
        assert t.parent == 0 and step.parent == t.id
        assert t.start <= step.start <= step.end <= t.end
    assert all(a.end <= b.start for a, b in zip(ticks, ticks[1:]))
    hist = {dict(k)["phase"]: v for k, v in ph.series().items()}
    assert sum(h["count"] for h in hist.values()) == 4 * eng.ticks
    assert tick_h.stats()["count"] == eng.ticks


def test_a_failed_tick_leaves_no_span_open(llama_port, monkeypatch):
    """A block step that raises closes the tick's span on the way out: the
    next span nests under nothing."""
    profiling.reset()
    eng = port_engine(llama_port, tllama, slots=2, max_new=2, eos_token=-1)

    def fail(step_in):
        raise RuntimeError("device lost")

    monkeypatch.setattr(eng, "_block_step", fail)
    with obs.using_obs():
        with pytest.raises(RuntimeError, match="device lost"):
            eng.run(requests(1))
        with obs.span("after"):
            pass
    recs = {r.name: r for r in profiling.recorded()}
    assert recs["serving/block_step"].parent == recs["serving/tick"].id
    assert recs["after"].parent == 0


def test_request_queue_spans_match_the_results(llama_port):
    """Every request records ``serving/request/queue`` from its arrival to
    its admission, and its ``Result`` carries the admission time."""
    profiling.reset()
    eng = port_engine(llama_port, tllama, slots=2, max_new=3, eos_token=-1)
    reqs = requests(4)
    for i, r in enumerate(reqs):
        r.arrival_s = 0.01 * i
    with obs.using_obs():
        t_run = time.perf_counter()
        res = eng.run(reqs)
    queue = [s for s in profiling.recorded()
             if s.name == "serving/request/queue"]
    assert {r.uid for r in res} == {0, 1, 2, 3} and len(queue) == 4
    for r in res:
        assert r.arrival_s <= r.admitted_s <= r.first_token_s <= r.finish_s
    assert all(s.parent == 0 and s.start >= t_run for s in queue)
    assert sorted(s.end - s.start for s in queue) == pytest.approx(
        sorted(r.admitted_s - r.arrival_s for r in res), abs=1e-9)
    # two slots for four requests: the last two wait in the queue
    assert max(s.end - s.start for s in queue) > 0


def test_wave_results_carry_admission_and_queue_spans(llama_port):
    profiling.reset()
    eng = port_engine(llama_port, tllama, slots=2, max_new=3, eos_token=-1,
                      scheduler="wave")
    with obs.using_obs():
        res = eng.run(requests(3))
    queue = [s for s in profiling.recorded()
             if s.name == "serving/request/queue"]
    assert len(queue) == 3
    for r in res:
        assert r.arrival_s <= r.admitted_s <= r.first_token_s


def test_train_step_phases_nest_under_a_cpu_profiler():
    """A SMOKE train step under a CPU profiler (no session) records
    ``train/step`` holding forward, backward, clip and update, in that
    order, and the profiler sees them as ranges."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import OptConfig
    from repro_torch.training import init_train_state, make_train_step

    profiling.reset()
    bundle = build_lm(tmamba.SMOKE)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    state = init_train_state(torch.Generator().manual_seed(0), bundle, opt)
    step = make_train_step(bundle, opt)
    tok = torch.randint(3, tmamba.SMOKE.vocab, (2, 17))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    step(state, batch)                  # nothing records
    assert profiling.recorded() == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    recs = profiling.recorded()
    (top,) = [r for r in recs if r.name == "train/step"]
    kids = sorted((r for r in recs if r.parent == top.id),
                  key=lambda r: r.start)
    assert [k.name for k in kids] == ["train/forward", "train/backward",
                                      "train/clip", "train/update"]
    assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
    assert top.start <= kids[0].start and kids[-1].end <= top.end
    ranges = {e.name for e in prof.events()}
    assert {"train/step", "train/forward", "train/backward", "train/clip",
            "train/update"} <= ranges


def test_serve_cli_writes_all_three_artifacts(tmp_path, capsys):
    """``--obs-events``, ``--metrics-out`` and ``--profile-dir`` on the
    serve launcher: the JSON-lines events, the Prometheus text (its token
    count is the run's) and a Chrome trace holding the block-step spans."""
    ev, prom, prof = (tmp_path / "e.jsonl", tmp_path / "m.prom",
                      tmp_path / "trace")
    eng = tserve.main([
        "--arch", "llama3.2-1b", "--config", "smoke", "--device", "cpu",
        "--requests", "3", "--max-new", "3", "--prompt-len", "40",
        "--cache", "paged", "--pool-pages", "40", "--page-rows", "8",
        "--obs-events", str(ev), "--metrics-out", str(prom),
        "--profile-dir", str(prof)])
    assert "3 requests" in capsys.readouterr().out
    assert obs.active() is None
    events = obs.load_jsonl(str(ev))
    kinds = {e["kind"] for e in events}
    assert {"serving", "resolution", "kernel_invoke", "kv_alloc"} <= kinds
    admits = [e for e in events if e["kind"] == "serving"
              and e["event"] == "admit"]
    assert len(admits) == 3
    n_tok = sum(len(r.tokens) for r in eng.results)
    assert f"repro_serving_tokens_total {n_tok}\n" in prom.read_text()
    (trace,) = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    names = [e.get("name") for e in json.load(open(trace))["traceEvents"]]
    assert names.count("serving/block_step") == eng.ticks
