"""The port's MeshContext (``repro_torch.parallel.mesh_context``) and the
policy's shard-shape hook against the JAX package's on the CPU.

The counterparts of ``tests/test_multihost.py``'s unit cases: resolution
keyed by the shard's shape under a topology-only context (a two-band table
in the port's format, fresh and memoised), the divisor's degradation on a
bucket it does not divide, ``shard_local_scope``, ``parse_mesh_arg``; then
the ``resolution`` event's ``n``, ``shard_n``, ``shard_divisor`` and
``band`` against the reference's for the same calls, the context's
validation and keys, and ``make_context`` on a one-process CPU group.
"""
from __future__ import annotations

import json
import threading
import warnings

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.core import autotune as rautotune
from repro.core.policy import KernelPolicy as RPolicy
from repro.obs import using_obs as rusing_obs
from repro.parallel import mesh_context as rmesh
from repro.parallel.sharding import Rules as RRules
from repro_torch.core import autotune as tautotune
from repro_torch.core.policy import KernelPolicy
from repro_torch.obs import using_obs
from repro_torch.parallel import mesh_context as tmesh
from repro_torch.parallel.mesh_context import (
    MeshContext,
    activate,
    current_mesh_context,
    effective_call_n,
    make_context,
    parse_mesh_arg,
    shard_local_scope,
)
from repro_torch.parallel.sharding import Rules

CPU = torch.device("cpu")


def _topology_ctx(op_shard_axes, sizes):
    """Topology-only context: policy resolution without a process group."""
    return MeshContext(mesh=None, rules=Rules(table={},
                                              axis_sizes=dict(sizes)),
                       op_shard_axes=op_shard_axes)


def _ref_topology_ctx(op_shard_axes, sizes):
    return rmesh.MeshContext(mesh=None,
                             rules=RRules(table={}, axis_sizes=dict(sizes)),
                             op_shard_axes=op_shard_axes)


# the two bands resolve to different paths AND TuneSpecs, so a test can
# tell which shape resolution keyed off
TWO_BAND = {
    "scan/f32/10": {"path": "tile_logdepth", "us": {"tile_logdepth": 1.0},
                    "tuning": {"block_n": 256}},
    "scan/f32/8": {"path": "baseline", "us": {"baseline": 1.0}},
    "reduce/f32/10": {"path": "fused", "us": {"fused": 1.0}},
    "reduce/f32/8": {"path": "baseline", "us": {"baseline": 1.0}},
}


@pytest.fixture
def two_band_policy(tmp_path):
    path = tmp_path / "two_band.json"
    path.write_text(json.dumps({"version": 3, "backends": {"cpu": {
        "torch": torch.__version__, "entries": TWO_BAND}}}))
    tautotune.invalidate_cache()
    try:
        yield KernelPolicy(path="auto", autotune="on",
                           autotune_table=str(path))
    finally:
        tautotune.invalidate_cache()


def _resolve(pol, op, n):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # tile_logdepth on a CPU tensor
        return pol.resolve(op, n, torch.float32, device=CPU)


def test_resolve_buckets_by_shard_shape(two_band_policy):
    """Under an active MeshContext, resolve(op, n) keys off the shard's
    shape: the path AND TuneSpec are the shard's."""
    pol = two_band_policy
    full = _resolve(pol, "scan", 1024)
    shard_direct = _resolve(pol, "scan", 256)
    assert str(full) == "tile_logdepth" and str(shard_direct) == "baseline"
    assert full.tuning != shard_direct.tuning
    ctx = _topology_ctx({"scan": "model"}, {"model": 4})
    with ctx:
        in_ctx = _resolve(pol, "scan", 1024)
    assert str(in_ctx) == str(shard_direct) == "baseline"
    assert in_ctx.tuning == shard_direct.tuning
    # ops with no registered shard axis are untouched
    with ctx:
        assert str(_resolve(pol, "reduce", 1024)) == "fused"
        assert ctx.effective_n("reduce", 1024) == 1024


def test_resolve_memo_keys_off_the_shard(two_band_policy):
    """A resolution memoised outside a context is not served inside one,
    nor the other way round."""
    pol = two_band_policy
    ctx = _topology_ctx({"segmented_scan": "model"}, {"model": 4})
    for _ in range(2):
        assert str(_resolve(pol, "scan", 1024)) == "tile_logdepth"
        with ctx:
            assert str(_resolve(pol, "scan", 1024)) == "baseline"
            # the kernel-registry alias shards too
            assert str(pol.resolve("segmented_scan", 1024, torch.float32,
                                   device=CPU, level="kernel")) == "fused"
        assert str(_resolve(pol, "scan", 1024)) == "tile_logdepth"


def test_resolve_shard_divisor_degrades_on_non_divisible():
    ctx = _topology_ctx({"reduce": "model"}, {"model": 4})
    assert ctx.effective_n("reduce", 1024) == 256
    assert ctx.effective_n("reduce", 1023) == 1023
    assert ctx.shard_divisor("reduce", 1023) == 1
    ref = _ref_topology_ctx({"reduce": "model"}, {"model": 4})
    for n in (1024, 1023, 4, 2, 1):
        assert ctx.effective_n("reduce", n) == ref.effective_n("reduce", n)


def test_shard_local_scope_suppresses_division():
    ctx = _topology_ctx({"reduce": "model"}, {"model": 4})
    with ctx:
        assert effective_call_n("reduce", 1024) == 256
        with shard_local_scope():
            assert effective_call_n("reduce", 1024) == 1024
        assert effective_call_n("reduce", 1024) == 256
    assert effective_call_n("reduce", 1024) == 1024


def test_context_is_scoped_and_does_not_cross_threads():
    ctx = _topology_ctx({"ssd": "data"}, {"data": 2})
    seen = []
    assert current_mesh_context() is None
    with activate(ctx) as got:
        assert got is ctx and current_mesh_context() is ctx
        t = threading.Thread(target=lambda: seen.append(
            current_mesh_context()))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        inner = _topology_ctx({}, {"data": 4})
        with inner:
            assert current_mesh_context() is inner
        assert current_mesh_context() is ctx
    assert seen == [None]
    assert current_mesh_context() is None
    with activate(None) as got:
        assert got is None and current_mesh_context() is None


@pytest.mark.parametrize("spec", ["data=2,model=2", " data=4 ",
                                  "pod=2,data=16,model=16", "data=4,,"])
def test_parse_mesh_arg(spec):
    assert parse_mesh_arg(spec) == rmesh.parse_mesh_arg(spec)


@pytest.mark.parametrize("spec", ["data", "data=0", "", "=4", "data=-1"])
def test_parse_mesh_arg_rejects(spec):
    with pytest.raises(ValueError):
        rmesh.parse_mesh_arg(spec)
    with pytest.raises(ValueError):
        parse_mesh_arg(spec)


def test_context_validation_and_keys_match_reference():
    pairs = {"ssd_scan": "data", "segmented_reduce": "model",
             "weighted_scan": "data"}
    sizes = {"data": 2, "model": 4}
    ctx, ref = _topology_ctx(pairs, sizes), _ref_topology_ctx(pairs, sizes)
    assert ctx.op_shard_axes == ref.op_shard_axes
    assert ctx.label() == ref.label() == "data=2,model=4"
    assert ctx.key() == ref.key()
    assert ctx.axis_sizes == ref.axis_sizes
    for op in ("ssd", "ssd_scan", "reduce", "scan", "attention"):
        assert ctx.shard_axis(op) == ref.shard_axis(op)
    assert ctx.process_index == 0 and ctx.process_count == 1
    assert _topology_ctx({}, {}).label() == "none"
    with pytest.raises(ValueError, match="unknown op"):
        _topology_ctx({"sort": "data"}, sizes)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        _topology_ctx({"scan": "pod"}, sizes)
    with pytest.raises(ValueError, match="topology-only"):
        ctx.placements((None,))
    assert tmesh.DEFAULT_RULE_TABLE == rmesh.DEFAULT_RULE_TABLE


# (op, n, dtype) calls resolved under both packages' contexts
EVENT_CALLS = [("reduce", 1024), ("reduce", 1023), ("scan", 4096),
               ("scan", 4), ("ssd", 512), ("attention", 512),
               ("segmented_reduce", 2048), ("weighted_scan", 1 << 20)]
SHARD_AXES = {"reduce": "model", "scan": "model", "ssd": "data",
              "weighted_scan": "data"}
SIZES = {"data": 2, "model": 4}


def _event_fields(events):
    return [(e["op"], e["n"], e["shard_n"], e["shard_divisor"], e["band"])
            for e in events]


@pytest.mark.parametrize("local", [False, True])
def test_resolution_event_shard_fields_match_reference(local):
    """The same calls under the same topology: each ``resolution`` event's
    ``n``, ``shard_n``, ``shard_divisor`` and ``band`` equal the
    reference's (inside ``shard_local_scope`` nothing is divided)."""
    ctx = _topology_ctx(SHARD_AXES, SIZES)
    ref = _ref_topology_ctx(SHARD_AXES, SIZES)
    pol, rpol = KernelPolicy(), RPolicy()
    rautotune.invalidate_cache()
    with using_obs() as sess, ctx:
        scope = shard_local_scope() if local else _nothing()
        with scope:
            for op, n in EVENT_CALLS:
                pol.resolve(op, n, torch.float32, device=CPU)
    with rusing_obs() as rsess, ref:
        scope = rmesh.shard_local_scope() if local else _nothing()
        with scope:
            for op, n in EVENT_CALLS:
                rpol.resolve(op, n, jnp.float32)
    got = _event_fields(sess.events.events("resolution"))
    want = _event_fields(rsess.events.events("resolution"))
    assert got == want
    divisors = [d for _, _, _, d, _ in got]
    assert divisors == ([1] * len(EVENT_CALLS) if local
                        else [4, 1, 4, 4, 2, 1, 4, 2])


def test_resolution_event_outside_a_context():
    with using_obs() as sess:
        KernelPolicy().resolve("scan", 4096, torch.float32, device=CPU)
    (ev,) = sess.events.events("resolution")
    assert (ev["n"], ev["shard_n"], ev["shard_divisor"]) == (4096, 4096, 1)


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


def test_make_context_needs_a_process_group():
    if dist.is_initialized():
        pytest.fail("a process group is already initialised in this worker")
    with pytest.raises(RuntimeError, match="process group"):
        make_context("data=1", device="cpu")


def test_make_context_on_a_one_process_cpu_group(tmp_path):
    if dist.is_initialized():
        pytest.fail("a process group is already initialised in this worker")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 devices; this "
                                             "process group has 1"):
            make_context("data=2", device="cpu")
        ctx = make_context("data=1", device="cpu",
                           op_shard_axes={"scan": "data"})
        assert ctx.axis_sizes == {"data": 1}
        assert tuple(ctx.mesh.mesh_dim_names) == ("data",)
        assert ctx.rules.fsdp is None and ctx.rules.table == \
            tmesh.DEFAULT_RULE_TABLE
        assert (ctx.process_index, ctx.process_count) == (0, 1)
        assert ctx.label() == "data=1"
        with ctx:
            assert effective_call_n("scan", 64) == 64   # one-way: no split
        ctx2 = make_context((("data", 1), ("model", 1)), device="cpu",
                            fsdp=True, table={"heads": "model"})
        assert ctx2.rules.fsdp is None          # data is one-way
        assert ctx2.rules.table == {"heads": "model"}
        from torch.distributed.tensor import Replicate, Shard
        assert ctx2.placements((None, "model")) == (Replicate(), Shard(1))
    finally:
        dist.destroy_process_group()
    # the reference raises the same for a mesh its devices cannot fill
    with pytest.raises(ValueError, match="needs 2 devices"):
        rmesh.make_context("data=2")
    assert jax.device_count() == 1
