"""Sharded training of the port (``train_state_pspecs``,
``state_shape_structs``, the sharded train step, the sharded checkpoint and
its elastic restore, the data pipeline's rows by data coordinate, the
launcher's mesh) against the JAX package's on the CPU.

The specs and shapes are compared in this process. The sharded runs need
several ranks, hence several processes: one module-scoped fixture carries
the reference's initial train state of llama3.2-1b SMOKE (f32) into numpy,
runs the reference's unsharded ``make_train_step`` on it here, writes a
reference checkpoint, and starts

* a gloo world of 4 processes: 3 steps on a ``data=2,model=2`` mesh from
  that state (and the port's unsharded step beside them on rank 0), the
  checkpoint of the result, the reference's checkpoint restored under the
  2x2 specs, ``build_mesh_context(2)``, and one step on a ``data=4`` mesh
  saved for the elastic restart;
* then a gloo world of 2 processes: that ``data=4`` checkpoint restored on
  a ``data=2`` mesh and one more step.

The worlds join by a ``file://`` init in a temporary directory (no port to
collide under xdist). Each test then reads one result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.models import build as jbuild
from repro.optim import OptConfig as JOptConfig
from repro.parallel.sharding import Rules as JRules
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as jinit_train_state
from repro.training import make_train_step as jmake_train_step
from repro.training.train_lib import state_shape_structs as jshape_structs
from repro.training.train_lib import train_state_pspecs as jpspecs
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.models import build as tbuild
from repro_torch.optim import OptConfig
from repro_torch.parallel.sharding import Rules
from repro_torch.training import TrainConfig, state_shape_structs, \
    train_state_pspecs

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300          # seconds, each world
ARCH = "llama3.2-1b"
BATCH, SEQ, STEPS = 4, 16, 3
OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
# tests/test_distributed.py's 2x2 rules
TABLE = {"batch": ("data",), "heads": "model", "kv_heads": "model",
         "ff": "model", "vocab": "model", "embed": None, "layers": None}
SIZES = {"data": 2, "model": 2}


# ---------------------------------------------------------------------------
# the specs and shapes, in this process


def _jax_leaves(t):
    """{keystr: leaf} of the reference's tree, a PartitionSpec whole."""
    spec = jax.sharding.PartitionSpec
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(
                t, is_leaf=lambda x: isinstance(x, spec))}


def _port_specs(specs, like):
    """{keystr: spec} of the port's spec tree, walked by the state's tree
    (a spec is a tuple, which ``tree.items`` would enter)."""
    out = {}

    def walk(t, s, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s[k], f"{prefix}[{k!r}]")
        else:
            out[prefix] = s

    walk(like, specs, "")
    return out


SPEC_CASES = [(arch, opt, comp)
              for arch in ("llama3.2-1b", "mamba2-1.3b", "qwen3-moe-235b-a22b")
              for opt in ("adamw", "adafactor") for comp in (False, True)]


@pytest.mark.parametrize("arch,optimizer,compress", SPEC_CASES)
def test_train_state_pspecs_match_reference(arch, optimizer, compress):
    """Spec for spec, under tests/test_distributed.py's 2x2 rules."""
    want = {k: tuple(v) for k, v in _jax_leaves(jpspecs(
        jbuild(jconfigs.get(arch).SMOKE),
        JRules(table=TABLE, fsdp="data", axis_sizes=SIZES),
        JTrainConfig(optimizer=optimizer, compress_grads=compress))).items()}
    bundle = tbuild(tconfigs.get(arch).SMOKE)
    tc = TrainConfig(optimizer=optimizer, compress_grads=compress)
    got = _port_specs(
        train_state_pspecs(bundle, Rules(table=TABLE, fsdp="data",
                                         axis_sizes=SIZES), tc),
        state_shape_structs(bundle, OptConfig(), tc))
    assert got == want
    assert any(s and any(s) for s in got.values())      # something shards


@pytest.mark.parametrize("arch,optimizer,compress", SPEC_CASES)
def test_state_shape_structs_match_reference(arch, optimizer, compress):
    """Shapes and dtypes, leaf for leaf; the port's leaves hold no
    storage."""
    want = _jax_leaves(jshape_structs(
        jbuild(jconfigs.get(arch).SMOKE), JOptConfig(),
        JTrainConfig(optimizer=optimizer, compress_grads=compress)))
    got = dict(tree.items(state_shape_structs(
        tbuild(tconfigs.get(arch).SMOKE), OptConfig(),
        TrainConfig(optimizer=optimizer, compress_grads=compress))))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == \
            np.dtype(want[k].dtype).name, k


# ---------------------------------------------------------------------------
# the worlds

WORKER = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, f"init{world}"), rank=rank, world_size=world)
from repro_torch import configs, tree
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.launch.train import build_mesh_context
from repro_torch.models import build
from repro_torch.optim import OptConfig
from repro_torch.parallel import make_context
from repro_torch.parallel.sharded_state import full_tensor, local
from repro_torch.parallel.sharding import is_dtensor, spec_of
from repro_torch.training import (init_train_state, make_train_step,
                                  shard_train_state, state_shardings,
                                  train_state_pspecs)

torch.manual_seed(0)
cfg = configs.get("llama3.2-1b").SMOKE
bundle = build(cfg)
opt_cfg = OptConfig(**json.loads(sys.argv[4]))
batch = {k: torch.from_numpy(np.load(os.path.join(d, k + ".npy")))
         for k in ("tokens", "labels")}
out, info = {}, {}


def whole_state():
    # the reference's initial state, carried in as numpy by keystr
    z = np.load(os.path.join(d, "state0.npz"))
    tmpl = init_train_state(torch.Generator().manual_seed(1), bundle,
                            opt_cfg)
    return tree.unflatten(tmpl, [
        z[k] if isinstance(leaf, np.ndarray) else torch.from_numpy(z[k])
        for k, leaf in tree.items(tmpl)])


def save_tree(prefix, state):
    for k, leaf in tree.items(state):
        v = full_tensor(leaf) if isinstance(leaf, torch.Tensor) else leaf
        out[prefix + k] = np.asarray(v)


def rows(ctx):
    data = SyntheticLMPipeline(DataConfig(vocab=cfg.vocab, seq_len=16,
                                          global_batch=4), device="cpu",
                               sharding=ctx)
    lo, hi = data.host_range()
    return (lo, hi), {k: v[lo:hi] for k, v in batch.items()}


if world == 4:
    ctx = make_context("data=2,model=2", device="cpu")
    info["tp2"] = build_mesh_context(2, device="cpu").label()
    info["rows"], mine = rows(ctx)
    state = shard_train_state(whole_state(), bundle, ctx)
    info["placements"] = {k: str(spec_of(v)) for k, v in
                          tree.items(state) if is_dtensor(v)}
    info["local_shapes"] = {k: list(local(v).shape) for k, v in
                            tree.items(state["params"])}
    step = make_train_step(bundle, opt_cfg, mesh_ctx=ctx)
    losses, norms = [], []
    for i in range(3):
        state, m = step(state, mine)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:
            save_tree("step1", state)
    info["losses"], info["norms"] = losses, norms
    info["split"] = sorted(step.split)
    save_tree("final", state)
    info["step_type"] = type(state["opt"]["step"]).__name__
    path = ckpt.save(os.path.join(d, "port_ckpt"), 3, state)
    info["files"] = sorted(os.listdir(path))
    with open(os.path.join(path, "manifest.json")) as f:
        info["n_hosts"] = json.load(f)["n_hosts"]
    if rank == 0:       # the port's unsharded step beside it
        u = whole_state()
        ustep = make_train_step(bundle, opt_cfg)
        ulosses = []
        for i in range(3):
            u, m = ustep(u, batch)
            ulosses.append(float(m["loss"]))
        info["u_losses"] = ulosses
        save_tree("unsharded", u["params"])
    # the reference's checkpoint, restored under this mesh's specs
    tmpl = shard_train_state(whole_state(), bundle, ctx)
    got = ckpt.restore(os.path.join(d, "ref_ckpt"), 1, tmpl,
                       shardings=state_shardings(
                           tmpl, train_state_pspecs(bundle, ctx.rules), ctx))
    info["ref_restored_sharded"] = all(
        is_dtensor(v) for v in tree.leaves(got["params"]))
    save_tree("fromref", got)
    # elastic: one step on data=4, saved for the 2-rank world
    ctx4 = make_context("data=4", device="cpu")
    s4 = shard_train_state(whole_state(), bundle, ctx4)
    s4, m = make_train_step(bundle, opt_cfg, mesh_ctx=ctx4)(
        s4, rows(ctx4)[1])
    info["elastic_loss"] = float(m["loss"])
    save_tree("elastic", s4)
    ckpt.save(os.path.join(d, "elastic"), 1, s4)
else:
    ctx = make_context("data=2", device="cpu")
    tmpl = shard_train_state(whole_state(), bundle, ctx)
    got = ckpt.restore(os.path.join(d, "elastic"), 1, tmpl,
                       shardings=state_shardings(
                           tmpl, train_state_pspecs(bundle, ctx.rules), ctx))
    info["restored_local_shapes"] = {k: list(local(v).shape) for k, v in
                                     tree.items(got["params"])}
    save_tree("restored", got)
    got, m = make_train_step(bundle, opt_cfg, mesh_ctx=ctx)(got,
                                                            rows(ctx)[1])
    info["step_after"] = int(got["opt"]["step"])
    info["loss_after"] = float(m["loss"])

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
        if key in os.environ:
            env[key] = os.environ[key]
    return env


def _run_world(size: int, d: Path) -> None:
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(WORKER), str(r), str(size),
         str(d), json.dumps(OPT)], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(size)]
    failed = {}
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            failed[r] = f"timed out after {TIMEOUT} s\n{err[-2000:]}"
            continue
        if proc.returncode != 0:
            failed[r] = err[-3000:]
    if failed:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        pytest.fail(f"world of {size}: " + "; ".join(
            f"rank {k}: {v}" for k, v in failed.items()))


def _np_tree(t) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(t)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_train")
    jbundle = jbuild(dataclasses.replace(jconfigs.get(ARCH).SMOKE,
                                         policy="fused"))
    jopt = JOptConfig(policy="fused", **OPT)
    state = jinit_train_state(jax.random.PRNGKey(0), jbundle, jopt)
    np.savez(d / "state0.npz", **_np_tree(state))
    rng = np.random.default_rng(0)
    tok = rng.integers(1, jconfigs.get(ARCH).SMOKE.vocab,
                       size=(BATCH, SEQ + 1), dtype=np.int32)
    np.save(d / "tokens.npy", tok[:, :-1])
    np.save(d / "labels.npy", tok[:, 1:])
    # the reference, unsharded, on the whole batch
    jstep = jax.jit(jmake_train_step(jbundle, jopt))
    batch = {"tokens": jnp.asarray(tok[:, :-1]),
             "labels": jnp.asarray(tok[:, 1:])}
    ref = {"losses": []}
    for i in range(STEPS):
        state, m = jstep(state, batch)
        ref["losses"].append(float(m["loss"]))
        if i == 0:
            jckpt.save(str(d / "ref_ckpt"), 1, state)
            ref["after1"] = _np_tree(state)
    ref["final"] = _np_tree(state)
    ref["template"] = state
    _run_world(4, d)
    _run_world(2, d)
    out = {"dir": d, "ref": ref}
    for size in (4, 2):
        out[size] = [(dict(np.load(d / f"w{size}_r{r}.npz")),
                      json.loads((d / f"w{size}_r{r}.json").read_text()))
                     for r in range(size)]
    return out


def test_sharded_losses_fall_and_match_reference_and_unsharded(world):
    """3 steps on the 2x2 mesh: the same loss on every rank, falling, within
    1e-5 of the reference's unsharded step and of the port's; the step's
    parts those of the tensor-parallel route that llama takes on a split
    model dim (its activations' all-reduces over model among them)."""
    infos = [info for _, info in world[4]]
    losses = infos[0]["losses"]
    for info in infos[1:]:
        assert info["losses"] == losses
    assert losses[0] > losses[1] > losses[2]
    np.testing.assert_allclose(losses, world["ref"]["losses"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(losses, infos[0]["u_losses"], rtol=0,
                               atol=1e-5)
    assert infos[0]["split"] == ["forward_backward", "gather",
                                 "reduce_scatter", "tp_all_reduce", "update"]


def test_sharded_params_match_unsharded(world):
    """The gathered params after 3 steps: the same on every rank and within
    1e-5 of the port's unsharded run from the same state."""
    arrs = [a for a, _ in world[4]]
    n = 0
    for key in world["ref"]["final"]:
        if not key.startswith("['params']"):
            continue
        got = arrs[0]["final" + key]
        for other in arrs[1:]:
            np.testing.assert_array_equal(other["final" + key], got)
        np.testing.assert_allclose(
            got, arrs[0]["unsharded" + key[len("['params']"):]], rtol=0,
            atol=1e-5, err_msg=key)
        n += 1
    assert n == 11      # the stacked leaves: 9 a layer, embed, final_norm


def test_sharded_first_step_matches_reference(world):
    """The params after the first sharded step against the reference's
    unsharded step: within 1e-5 (atol 1e-6 and rtol 1e-5) plus what AdamW's
    first update adds where the two packages' gradients differ, as
    tests/test_torch_training.py holds the unsharded port: the update is
    ``lr g / (|g| + eps)``, which moves by up to ``lr eps dg / (|g| - dg +
    eps)^2`` (at most ``2 lr``) for a gradient difference ``dg`` (rtol 1e-4,
    atol 1e-6), so elements whose gradient is near ``eps`` may differ."""
    arrs = world[4][0][0]
    after = world["ref"]["after1"]
    lr, eps = OPT["peak_lr"], 1e-8
    for key, want in after.items():
        if not key.startswith("['params']"):
            continue
        g = np.abs(after["['opt']['m']" + key[len("['params']"):]]
                   .astype(np.float64)) / (1 - 0.9)
        dg = 1e-4 * g + 1e-6
        slack = lr * np.minimum(
            2.0, eps * dg / (np.maximum(g - dg, 0.0) + eps) ** 2)
        err = np.abs(arrs["step1" + key].astype(np.float64) - want)
        bound = 1e-6 + 1e-5 * np.abs(want) + slack
        assert np.all(err <= bound), (key, float(np.max(err - bound)))


def test_state_sharded_as_specs_and_rows_by_data_coordinate(world):
    """Every parameter, moment and step of the 2x2 state: the specs'
    placements, a quarter (or half) of each leaf a rank; rows by the data
    coordinate (ranks of one model group share them); ``--tp 2`` on a
    world of 4 is ``data=2,model=2``."""
    infos = [info for _, info in world[4]]
    bundle = tbuild(tconfigs.get(ARCH).SMOKE)
    specs = train_state_pspecs(bundle, Rules(table=TABLE, fsdp="data",
                                             axis_sizes=SIZES))
    want = {k: str(v) for k, v in _port_specs(
        specs, state_shape_structs(bundle, OptConfig())).items()
        if v != ()}
    assert infos[0]["placements"] == want
    shapes = dict(tree.items(state_shape_structs(bundle, OptConfig())))
    for k, shp in infos[0]["local_shapes"].items():
        assert np.prod(shp) * 4 == np.prod(shapes["['params']" + k].shape) \
            or np.prod(shp) * 2 == np.prod(shapes["['params']" + k].shape), k
    assert [info["rows"] for info in infos] == [[0, 2], [0, 2], [2, 4],
                                                [2, 4]]
    assert {info["tp2"] for info in infos} == {"data=2,model=2"}
    assert {info["step_type"] for info in infos} == {"Tensor"}


def test_sharded_checkpoint_restores_in_reference(world):
    """The port's 2x2 checkpoint (each rank's shards, no replica twice)
    restores bit-equal through ``repro.checkpoint.ckpt.restore``."""
    infos = [info for _, info in world[4]]
    assert infos[0]["files"] == [f"host_{i}.npz" for i in range(4)] + [
        "manifest.json"]
    assert {info["n_hosts"] for info in infos} == {4}
    got = _np_tree(jckpt.restore(str(world["dir"] / "port_ckpt"), 3,
                                 world["ref"]["template"]))
    arrs = world[4][0][0]
    for key, v in got.items():
        np.testing.assert_array_equal(v, arrs["final" + key], err_msg=key)
    # no shard written twice: the host files hold each leaf's elements once
    total = 0
    for i in range(4):
        with np.load(world["dir"] / "port_ckpt" / "step_3"
                     / f"host_{i}.npz") as z:
            total += sum(z[k].size for k in z.files
                         if not k.startswith("['opt']['step']")
                         and not k.startswith("['rng']"))
    whole = sum(v.size for k, v in got.items()
                if k not in ("['opt']['step']", "['rng']"))
    assert total == whole


def test_reference_checkpoint_restores_sharded_in_port(world):
    """The reference's checkpoint restores under the port's 2x2 specs,
    bit-equal to what it saved."""
    want = world["ref"]["after1"]
    for arrs, info in world[4]:
        assert info["ref_restored_sharded"]
        for key, v in want.items():
            np.testing.assert_array_equal(arrs["fromref" + key], v,
                                          err_msg=key)


def test_elastic_restore_from_4_ranks_to_2(world):
    """Saved under data=4, restored under data=2: bit-equal leaves, half of
    each leaf a rank, and one more step counts 2."""
    saved = world[4][0][0]
    for arrs, info in world[2]:
        for key in [k for k in saved if k.startswith("elastic")]:
            np.testing.assert_array_equal(
                arrs["restored" + key[len("elastic"):]], saved[key],
                err_msg=key)
        assert info["step_after"] == 2
        assert np.isfinite(info["loss_after"])
    assert world[2][0][1]["loss_after"] == world[2][1][1]["loss_after"]
