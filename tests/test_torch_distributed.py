"""The port's multi-device ops (``repro_torch.core.distributed``,
``repro_torch.parallel.shard_ops``, ``repro_torch.parallel.pipeline``)
against the JAX package's on the CPU.

Several ranks need several processes: one module-scoped fixture writes the
inputs (numpy, seeded) and starts, side by side and each under its own
timeout,

* the reference in one subprocess over 4 host devices
  (``--xla_force_host_platform_device_count=4``, as
  ``tests/test_distributed.py`` runs it): ``dist_reduce``,
  ``dist_exclusive_carry``, ``dist_scan``, ``weighted_exclusive_carry``,
  ``dist_weighted_scan`` inside ``shard_map`` and ``pipeline_apply``;
* the port in a gloo world of 4 processes and in one of 2, joined by a
  ``file://`` init in a temporary directory (no port to collide under
  xdist): the same ``dist_*`` ops on each rank's piece, the public ops on
  ``DTensor``s under ``make_context(device="cpu")`` (on the default policy
  and on ``"tile"``, the kernels' plain versions), the fallbacks, the route
  events, and the GPipe schedule on a ``stage`` mesh.

Each test then reads one result. The reference's ``shard_ops`` tests fail
at jax 0.9.0, so the sharded ops are held against the reference's
*unsharded* ``repro.ops`` and the port's own unsharded ops; the ``dist_*``
ops and the pipeline pass there and are held against the reference
directly, at its tests' tolerances.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ops as rops
import repro_torch.ops as tops

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300          # seconds, each subprocess
SSD_DIMS = (1, 128, 2, 8, 1, 4)          # B, L, H, P, G, N
POLICIES = ("default", "tile")


def _inputs(rng: np.random.Generator) -> dict:
    f32 = np.float32
    bsz, seqlen, h, p, g, n = SSD_DIMS
    out = {
        # tests/test_distributed.py's shapes
        "red_x": rng.standard_normal((4, 2, 512)).astype(f32),
        "scan_x": rng.standard_normal((3, 2048)).astype(f32),
        "ws_x": rng.standard_normal((2, 1024)).astype(f32),
        "ws_la": -rng.uniform(size=(2, 1024)).astype(f32),
        # the carries on their own, the SSD's (B, H, P, N) states among them
        "tot": rng.standard_normal((4, 2, 3)).astype(f32),
        "st_tot": rng.standard_normal((4, 2, 3, 4, 5)).astype(f32),
        "st_dec": -rng.uniform(size=(4, 2, 3)).astype(f32),
        # the sharded ops (tests/test_distributed.py's shard_ops shapes)
        "op_x": rng.standard_normal((3, 4096)).astype(f32),
        "op_la": -rng.uniform(size=(3, 4096)).astype(f32),
        "odd_x": rng.standard_normal((2, 1023)).astype(f32),
        "ssd_x": (0.2 * rng.standard_normal((bsz, seqlen, h, p)))
        .astype(f32),
        "ssd_dt": np.log1p(np.exp(rng.standard_normal((bsz, seqlen, h))))
        .astype(f32),
        "ssd_a": -np.exp(0.2 * rng.standard_normal((h,))).astype(f32),
        "ssd_b": (rng.standard_normal((bsz, seqlen, g, n)) / np.sqrt(n))
        .astype(f32),
        "ssd_c": (rng.standard_normal((bsz, seqlen, g, n)) / np.sqrt(n))
        .astype(f32),
        # the pipeline: S = 4 stages, M = 8 microbatches of 2, d = 16
        "pipe_w": (0.1 * rng.standard_normal((4, 16, 16))).astype(f32),
        "pipe_x": rng.standard_normal((16, 16)).astype(f32),
    }
    return out


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.core import (dist_exclusive_carry, dist_reduce, dist_scan,
                        dist_weighted_scan)
from repro.core.distributed import weighted_exclusive_carry
from repro.parallel.compat import make_mesh, shard_map
from repro.parallel.pipeline import (PipelineConfig, pipeline_apply,
                                     pipeline_stats)

d = sys.argv[1]
x = {k[:-4]: np.load(os.path.join(d, k)) for k in os.listdir(d)
     if k.endswith(".npy")}
mesh = make_mesh((4,), ("data",))
out = {}
out["reduce"] = shard_map(lambda v: dist_reduce(v, "data"), mesh=mesh,
                          in_specs=P("data"), out_specs=P())(x["red_x"])
seq = P(None, "data")
out["scan"] = shard_map(lambda v: dist_scan(v, "data"), mesh=mesh,
                        in_specs=seq, out_specs=seq)(x["scan_x"])
out["weighted_scan"] = shard_map(
    lambda v, l: dist_weighted_scan(v, l, "data"), mesh=mesh,
    in_specs=(seq, seq), out_specs=seq)(x["ws_x"], x["ws_la"])
out["carry"] = shard_map(
    lambda t: dist_exclusive_carry(t[0], "data")[None], mesh=mesh,
    in_specs=P("data"), out_specs=P("data"))(x["tot"])
out["weighted_carry"] = shard_map(
    lambda t, l: weighted_exclusive_carry(t[0], l[0], "data")[None],
    mesh=mesh, in_specs=(P("data"), P("data")),
    out_specs=P("data"))(x["st_tot"], x["st_dec"])
stage = make_mesh((4,), ("stage",))
cfg = PipelineConfig(n_stages=4, n_microbatches=8)
out["pipeline"] = pipeline_apply(lambda w, v: v + jnp.tanh(v @ w),
                                 x["pipe_w"], x["pipe_x"], cfg, stage)
st = pipeline_stats(cfg)
out["pipe_ticks"] = np.asarray(st["ticks"])
out["pipe_bubble"] = np.asarray(st["bubble_fraction"])
np.savez(os.path.join(d, "reference.npz"),
         **{k: np.asarray(v) for k, v in out.items()})
"""

WORKER = """
import json, os, sys, warnings
import numpy as np
import torch
import torch.distributed as dist

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, f"init{world}"), rank=rank, world_size=world)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import ops
from repro_torch.core import (dist_exclusive_carry, dist_reduce, dist_scan,
                              dist_weighted_scan, weighted_exclusive_carry)
from repro_torch.obs import using_obs
from repro_torch.parallel import make_context, shard_ops
from repro_torch.parallel.pipeline import (PipelineConfig, pipeline_apply,
                                           pipeline_stats)

x = {k[:-4]: torch.from_numpy(np.load(os.path.join(d, k)))
     for k in os.listdir(d) if k.endswith(".npy")}
out, info = {}, {}


def piece(t, dim, k=rank, parts=world):
    n = t.shape[dim] // parts
    return t.narrow(dim, k * n, n).contiguous()


def save(name, t):
    if isinstance(t, DTensor):
        t = t.to_local()
    out[name] = t.detach().numpy()


if world == 4:
    # the dist_* ops on this rank's piece, group = the default group
    save("reduce", dist_reduce(piece(x["red_x"], 0)))
    save("scan", dist_scan(piece(x["scan_x"], 1)))
    save("weighted_scan", dist_weighted_scan(piece(x["ws_x"], 1),
                                             piece(x["ws_la"], 1)))
    save("carry", dist_exclusive_carry(x["tot"][rank]))
    save("weighted_carry", weighted_exclusive_carry(x["st_tot"][rank],
                                                    x["st_dec"][rank]))
    try:
        weighted_exclusive_carry(x["st_tot"][rank], x["st_dec"][rank][:1])
    except ValueError:
        info["carry_shape_raises"] = True

ctx = make_context(f"data={world}", device="cpu")
mesh = ctx.mesh


def shard(t, dim):
    return DTensor.from_local(piece(t, dim), mesh, [Shard(dim)],
                              run_check=False)


def uneven(t, dim):
    # t split over the ranks as torch.chunk splits it (the last piece
    # shorter), as a DTensor of t's shape
    t = t.contiguous()
    base = -(-t.shape[dim] // world)
    local = t.narrow(dim, rank * base,
                     min(base, t.shape[dim] - rank * base)).contiguous()
    return DTensor.from_local(local, mesh, [Shard(dim)], run_check=False,
                              shape=t.shape, stride=t.stride())


def rep(t):
    return DTensor.from_local(t, mesh, [Replicate()], run_check=False)


xs, las = shard(x["op_x"], 1), shard(x["op_la"], 1)
ssd = [shard(x["ssd_x"], 1), shard(x["ssd_dt"], 1), x["ssd_a"],
       shard(x["ssd_b"], 1), shard(x["ssd_c"], 1)]
with warnings.catch_warnings():
    warnings.simplefilter("ignore")       # "tile" runs the plain versions
    for pol in ("default", "tile"):
        kw = {} if pol == "default" else {"policy": pol}
        with using_obs() as sess, ctx:
            r = ops.reduce(xs, **kw)
            s = ops.scan(xs, **kw)
            w = ops.weighted_scan(xs, las, **kw)
            y, h = ops.ssd(*ssd, return_state=True, **kw)
            y2 = ops.ssd(*ssd, **kw)
        for name, t in (("reduce", r), ("scan", s), ("weighted_scan", w),
                        ("ssd_y", y), ("ssd_h", h), ("ssd_y2", y2)):
            save(f"op_{pol}_{name}", t)
            info[f"placements_{pol}_{name}"] = [repr(p)
                                                for p in t.placements]
            info[f"shape_{pol}_{name}"] = list(t.shape)
        info[f"events_{pol}"] = [
            {k: e[k] for k in ("op", "n", "dim", "mesh_axes", "nshards")}
            for e in sess.events.events("sharded_dispatch")]
        info[f"prom_{pol}"] = sess.prometheus_text()
    # the fallbacks: plain dispatch, the same numbers
    odd = x["odd_x"]
    other = init_device_mesh("cpu", (world,), mesh_dim_names=("seq",))
    on_other = DTensor.from_local(piece(x["op_x"], 1), other, [Shard(1)],
                                  run_check=False)
    partial = DTensor.from_local(x["op_x"], mesh, [Partial()],
                                 run_check=False)
    with ctx:
        info["route_sharded"] = shard_ops._routing_ctx(xs, 1) is not None
        info["route_plain"] = shard_ops._routing_ctx(odd, 1) is None
        info["route_unsharded_axis"] = shard_ops._routing_ctx(xs, 0) is None
        info["route_other_mesh"] = shard_ops._routing_ctx(on_other, 1) \
            is None
        info["route_partial"] = shard_ops._routing_ctx(partial, 1) is None
        info["route_uneven"] = shard_ops._routing_ctx(uneven(odd, 1), 1) \
            is None
        short = [uneven(x[f"ssd_{k}"].narrow(1, 0, 127), 1)
                 for k in ("x", "dt")]
        info["uneven_ssd"] = shard_ops.sharded_ssd(
            *short, x["ssd_a"], *(uneven(x[f"ssd_{k}"].narrow(1, 0, 127), 1)
                                  for k in ("b", "c"))) is None
        save("fb_odd", ops.reduce(odd))
        info["fb_excl_route"] = shard_ops.sharded_scan(
            xs, exclusive=True) is None
        save("fb_excl", ops.scan(xs, exclusive=True).full_tensor())
        info["fb_wrep_route"] = shard_ops.sharded_weighted_scan(
            xs, rep(x["op_la"])) is None
        save("fb_wrep", ops.weighted_scan(xs, rep(x["op_la"]))
             .full_tensor())
        info["fb_ssd_a_sharded"] = shard_ops.sharded_ssd(
            *ssd[:2], shard(x["ssd_a"], 0), *ssd[3:]) is None
        info["fb_ssd_dt_replicated"] = shard_ops.sharded_ssd(
            ssd[0], rep(x["ssd_dt"]), *ssd[2:]) is None
    info["no_context"] = shard_ops.sharded_reduce(xs) is None

if world == 4:
    stage = init_device_mesh("cpu", (4,), mesh_dim_names=("stage",))
    cfg = PipelineConfig(n_stages=4, n_microbatches=8)
    save("pipeline", pipeline_apply(lambda w, v: v + torch.tanh(v @ w),
                                    x["pipe_w"], x["pipe_x"], cfg, stage))
    wd = DTensor.from_local(x["pipe_w"][rank:rank + 1], stage, [Shard(0)],
                            run_check=False)
    save("pipeline_dtensor", pipeline_apply(
        lambda w, v: v + torch.tanh(v @ w), wd, x["pipe_x"], cfg, stage))
    info["pipe_stats"] = pipeline_stats(cfg)
    try:
        pipeline_apply(lambda w, v: v, x["pipe_w"], x["pipe_x"],
                       PipelineConfig(n_stages=2, n_microbatches=8), stage)
    except ValueError:
        info["pipe_bad_stages_raises"] = True

np.savez(os.path.join(d, f"w{world}_r{rank}.npz"), **out)
with open(os.path.join(d, f"w{world}_r{rank}.json"), "w") as f:
    json.dump(info, f)
dist.barrier()
dist.destroy_process_group()
"""


def _env() -> dict:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    for key in ("JAX_PLATFORMS", "HOME", "TMPDIR"):
        if key in os.environ:    # a TPU-enabled jaxlib probes and hangs
            env[key] = os.environ[key]  # without the JAX_PLATFORMS pin
    return env


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    for name, arr in _inputs(np.random.default_rng(0)).items():
        np.save(d / f"{name}.npy", arr)
    env = _env()
    procs = {"reference": subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REFERENCE), str(d)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)}
    for size in (4, 2):
        for rank in range(size):
            procs[f"w{size}_r{rank}"] = subprocess.Popen(
                [sys.executable, "-c", textwrap.dedent(WORKER), str(rank),
                 str(size), str(d)], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    failed = {}
    for name, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            failed[name] = f"timed out after {TIMEOUT} s\n{err[-2000:]}"
            continue
        if proc.returncode != 0:
            failed[name] = err[-3000:]
    if failed:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        pytest.fail("; ".join(f"{k}: {v}" for k, v in failed.items()))
    out = {"dir": d, "ref": dict(np.load(d / "reference.npz"))}
    for size in (4, 2):
        out[size] = [(dict(np.load(d / f"w{size}_r{r}.npz")),
                      json.loads((d / f"w{size}_r{r}.json").read_text()))
                     for r in range(size)]
    return out


def _x(world, name) -> np.ndarray:
    return np.load(world["dir"] / f"{name}.npy")


def _cat(world, size, name, axis):
    return np.concatenate([w[0][name] for w in world[size]], axis=axis)


def _same_on_every_rank(world, size, name):
    first = world[size][0][0][name]
    for arrs, _ in world[size][1:]:
        np.testing.assert_array_equal(arrs[name], first)
    return first


# ---------------------------------------------------------------------------
# the dist_* ops against the reference's, tests/test_distributed.py's
# shapes and tolerances


def test_dist_reduce_matches_reference(world):
    got = _same_on_every_rank(world, 4, "reduce")
    np.testing.assert_allclose(got, world["ref"]["reduce"], rtol=1e-4)
    np.testing.assert_allclose(got, _x(world, "red_x").sum(dtype=np.float64),
                               rtol=1e-4)


def test_dist_scan_matches_reference(world):
    got = _cat(world, 4, "scan", 1)
    np.testing.assert_allclose(got, world["ref"]["scan"], rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(got, np.cumsum(_x(world, "scan_x"), -1),
                               rtol=1e-3, atol=1e-2)


def _weighted_oracle(x, la):
    ref = np.zeros(x.shape, np.float64)
    y = np.zeros(x.shape[:-1])
    for i in range(x.shape[-1]):
        y = np.exp(la[..., i].astype(np.float64)) * y + x[..., i]
        ref[..., i] = y
    return ref


def test_dist_weighted_scan_matches_reference(world):
    got = _cat(world, 4, "weighted_scan", 1)
    np.testing.assert_allclose(got, world["ref"]["weighted_scan"],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(
        got, _weighted_oracle(_x(world, "ws_x"), _x(world, "ws_la")),
        rtol=1e-3, atol=1e-3)


def test_dist_exclusive_carry_matches_reference(world):
    got = np.stack([w[0]["carry"] for w in world[4]])
    np.testing.assert_allclose(got, world["ref"]["carry"], rtol=1e-6,
                               atol=1e-6)
    tot = _x(world, "tot")
    want = np.concatenate([np.zeros_like(tot[:1]), np.cumsum(tot, 0)[:-1]])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_weighted_exclusive_carry_matches_reference(world):
    """The SSD's form: (B, H, P, N) states decayed by a (B, H) scalar."""
    got = np.stack([w[0]["weighted_carry"] for w in world[4]])
    np.testing.assert_allclose(got, world["ref"]["weighted_carry"],
                               rtol=1e-5, atol=1e-6)
    tot, dec = _x(world, "st_tot"), _x(world, "st_dec")
    h = np.zeros(tot.shape[1:])
    for i in range(4):
        np.testing.assert_allclose(got[i], h, rtol=1e-5, atol=1e-6)
        h = np.exp(dec[i])[..., None, None] * h + tot[i]
    assert all(w[1]["carry_shape_raises"] for w in world[4])


def test_pipeline_matches_reference(world):
    got = _same_on_every_rank(world, 4, "pipeline")
    np.testing.assert_allclose(got, world["ref"]["pipeline"], rtol=1e-5,
                               atol=1e-5)
    w, ref = _x(world, "pipe_w"), _x(world, "pipe_x")
    for s in range(4):
        ref = ref + np.tanh(ref @ w[s])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_same_on_every_rank(world, 4,
                                                   "pipeline_dtensor"),
                               got, rtol=0, atol=0)


def test_pipeline_stats_match_reference(world):
    for _, info in world[4]:
        st = info["pipe_stats"]
        assert st["ticks"] == 11 == int(world["ref"]["pipe_ticks"])
        assert abs(st["bubble_fraction"] - 3 / 11) < 1e-9
        assert abs(st["bubble_fraction"]
                   - float(world["ref"]["pipe_bubble"])) < 1e-9
        assert info["pipe_bad_stages_raises"]


# ---------------------------------------------------------------------------
# the sharded ops through repro_torch.ops, against both packages' unsharded
# ops


@pytest.fixture(scope="module")
def unsharded(world):
    x, la = _x(world, "op_x"), _x(world, "op_la")
    ssd = [_x(world, f"ssd_{k}") for k in "x dt a b c".split()]
    ty, th = tops.ssd(*map(torch.from_numpy, ssd), return_state=True)
    ry, rh = rops.ssd(*map(jnp.asarray, ssd), return_state=True)
    return {
        "reduce": (tops.reduce(torch.from_numpy(x)).numpy(),
                   np.asarray(rops.reduce(jnp.asarray(x)))),
        "scan": (tops.scan(torch.from_numpy(x)).numpy(),
                 np.asarray(rops.scan(jnp.asarray(x)))),
        "weighted_scan": (
            tops.weighted_scan(torch.from_numpy(x),
                               torch.from_numpy(la)).numpy(),
            np.asarray(rops.weighted_scan(jnp.asarray(x), jnp.asarray(la)))),
        "ssd_y": (ty.numpy(), np.asarray(ry)),
        "ssd_h": (th.numpy(), np.asarray(rh)),
    }


TOL = {"reduce": dict(rtol=1e-4, atol=1e-4), "scan": dict(rtol=1e-3,
                                                          atol=1e-2),
       "weighted_scan": dict(rtol=1e-3, atol=1e-3),
       "ssd_y": dict(rtol=2e-3, atol=2e-3), "ssd_h": dict(rtol=2e-3,
                                                          atol=2e-3)}
SHARDED = {"reduce": None, "scan": 1, "weighted_scan": 1, "ssd_y": 1,
           "ssd_h": None}


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("op", sorted(SHARDED))
def test_sharded_op_matches_unsharded(world, unsharded, size, policy, op):
    name = f"op_{policy}_{op}"
    axis = SHARDED[op]
    got = _same_on_every_rank(world, size, name) if axis is None \
        else _cat(world, size, name, axis)
    mine, ref = unsharded[op]
    np.testing.assert_allclose(got, mine, **TOL[op])
    np.testing.assert_allclose(got, ref, **TOL[op])


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_ssd_without_state_equals_with(world, size, policy):
    np.testing.assert_allclose(_cat(world, size, f"op_{policy}_ssd_y2", 1),
                               _cat(world, size, f"op_{policy}_ssd_y", 1),
                               rtol=1e-5, atol=1e-5)


# the reference's out specs: the reduce's and the state's replicated, the
# scans and y sharded as their input
OUT_SPECS = {"reduce": ["Replicate()"], "scan": ["Shard(dim=1)"],
             "weighted_scan": ["Shard(dim=1)"], "ssd_y": ["Shard(dim=1)"],
             "ssd_y2": ["Shard(dim=1)"], "ssd_h": ["Replicate()"]}


@pytest.mark.parametrize("policy", POLICIES)
def test_sharded_out_specs_and_shapes(world, policy):
    bsz, seqlen, h, p, g, n = SSD_DIMS
    shapes = {"reduce": [3], "scan": [3, 4096], "weighted_scan": [3, 4096],
              "ssd_y": [bsz, seqlen, h, p], "ssd_y2": [bsz, seqlen, h, p],
              "ssd_h": [bsz, h, p, n]}
    for size in (4, 2):
        for _, info in world[size]:
            for op, want in OUT_SPECS.items():
                assert info[f"placements_{policy}_{op}"] == want, op
                assert info[f"shape_{policy}_{op}"] == shapes[op], op


@pytest.mark.parametrize("size", [4, 2])
def test_route_events_and_counter(world, size):
    """One ``sharded_dispatch`` event a routed call, the reference's
    fields, and ``repro_sharded_dispatch_total`` by op."""
    want = [{"op": "reduce", "n": 4096, "dim": 1, "mesh_axes": ["data"],
             "nshards": size},
            {"op": "scan", "n": 4096, "dim": 1, "mesh_axes": ["data"],
             "nshards": size},
            {"op": "weighted_scan", "n": 4096, "dim": 1,
             "mesh_axes": ["data"], "nshards": size},
            {"op": "ssd", "n": 128, "dim": 1, "mesh_axes": ["data"],
             "nshards": size},
            {"op": "ssd", "n": 128, "dim": 1, "mesh_axes": ["data"],
             "nshards": size}]
    for _, info in world[size]:
        for policy in POLICIES:
            assert info[f"events_{policy}"] == want
            prom = info[f"prom_{policy}"]
            for op, count in (("reduce", 1), ("scan", 1),
                              ("weighted_scan", 1), ("ssd", 2)):
                assert (f'repro_sharded_dispatch_total{{op="{op}"}} '
                        f'{count}') in prom, prom


# ---------------------------------------------------------------------------
# the fallbacks: the reference's conditions, and plain dispatch's numbers

ROUTES = ("route_plain", "route_unsharded_axis", "route_other_mesh",
          "route_partial", "fb_excl_route", "fb_wrep_route",
          "fb_ssd_a_sharded", "fb_ssd_dt_replicated", "no_context")


@pytest.mark.parametrize("size", [4, 2])
@pytest.mark.parametrize("route", ROUTES)
def test_fallback_routes(world, size, route):
    for _, info in world[size]:
        assert info["route_sharded"]
        assert info[route], route


@pytest.mark.parametrize("size", [4, 2])
def test_fallback_uneven_shards(world, size):
    """A 1023-long axis, and an SSD of 127 positions: uneven shards, so
    plain dispatch."""
    for _, info in world[size]:
        assert info["route_uneven"] and info["uneven_ssd"]


@pytest.mark.parametrize("size", [4, 2])
def test_fallback_values(world, size):
    x, la, odd = _x(world, "op_x"), _x(world, "op_la"), _x(world, "odd_x")
    for arrs, _ in world[size]:
        np.testing.assert_allclose(arrs["fb_odd"], odd.sum(-1), rtol=1e-4,
                                   atol=1e-4)
        excl = np.concatenate([np.zeros_like(x[:, :1]),
                               np.cumsum(x, -1)[:, :-1]], -1)
        np.testing.assert_allclose(arrs["fb_excl"], excl, rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(
            arrs["fb_excl"],
            np.asarray(rops.scan(jnp.asarray(x), exclusive=True)),
            rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(arrs["fb_wrep"], _weighted_oracle(x, la),
                                   rtol=1e-3, atol=1e-3)
