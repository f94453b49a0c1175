"""The port's dry run against the JAX package's on the CPU: the configs'
shape cells, ``configs/common.py``, the production rules, the train state's
spec trees under them, the model FLOPs, and the dry run itself on a fake
world of 4 ranks (SMOKE llama and mamba: train, prefill and decode).

``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices when it is
imported, so its ``model_flops`` runs in a subprocess; everything else of
the reference is imported here. Each dry-run test starts its own fake
process group and destroys it after.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import common as jcommon
from repro.launch import mesh as jmesh
from repro.models import build as jbuild
from repro.optim import OptConfig as JOptConfig
from repro.parallel.sharding import spec_for as jspec_for
from repro.training import TrainConfig as JTrainConfig
from repro.training.train_lib import state_shape_structs as jshape_structs
from repro.training.train_lib import train_state_pspecs as jpspecs
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.configs import common as tcommon
from repro_torch.launch import dryrun, mesh as tmesh
from repro_torch.models import build as tbuild
from repro_torch.training import state_shape_structs, train_state_pspecs

ROOT = Path(__file__).resolve().parents[1]
ARCHS = jconfigs.all_arch_ids()
SHAPES = list(jcommon.SHAPE_TABLE)


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) \
        else np.dtype(dt).name


# ---------------------------------------------------------------------------
# configs


def test_all_arch_ids_match_reference():
    assert tconfigs.all_arch_ids() == jconfigs.all_arch_ids()


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_fields_match_reference(arch):
    """SHAPES, SKIPS (the same reasons), OPT_STATE_DTYPE and OPTIMIZER."""
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert t.SHAPES == j.SHAPES
    assert t.SKIPS == j.SKIPS
    assert t.OPT_STATE_DTYPE == j.OPT_STATE_DTYPE
    assert getattr(t, "OPTIMIZER", None) == getattr(j, "OPTIMIZER", None)
    # every arch runs or explicitly skips each shape (test_archs_smoke's)
    for shape in tcommon.SHAPE_TABLE:
        assert (shape in t.SHAPES) != (shape in t.SKIPS), (arch, shape)


def test_shape_table_matches_reference():
    assert tcommon.SHAPE_TABLE == jcommon.SHAPE_TABLE
    assert (tcommon.SMOKE_SEQ, tcommon.SMOKE_BATCH) == \
        (jcommon.SMOKE_SEQ, jcommon.SMOKE_BATCH)


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCHS
                                        for s in SHAPES])
def test_make_cell_matches_reference(arch, shape):
    """FULL configs: the same stand-ins (shapes, dtypes), logical axes,
    cache batch and length; the port's are ``meta`` tensors."""
    want = jcommon.make_cell(jconfigs.get(arch).FULL, shape)
    got = tcommon.make_cell(tconfigs.get(arch).FULL, shape)
    assert (got.shape, got.seq, got.batch, got.kind, got.cache_batch,
            got.cache_len) == (want.shape, want.seq, want.batch, want.kind,
                               want.cache_batch, want.cache_len)
    assert got.batch_specs.keys() == want.batch_specs.keys()
    assert got.batch_logical == want.batch_logical
    for k, t in got.batch_specs.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want.batch_specs[k].shape), k
        assert _dtype_name(t.dtype) == _dtype_name(
            want.batch_specs[k].dtype), k


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_batch_matches_reference(arch):
    """Keys, shapes, dtypes and ranges; the same generator seed twice gives
    the same tensors, another seed others."""
    jcfg, tcfg = jconfigs.get(arch).SMOKE, tconfigs.get(arch).SMOKE
    want = jcommon.smoke_batch(jcfg)
    got = tcommon.smoke_batch(tcfg)
    assert got.keys() == want.keys()
    for k, t in got.items():
        w = np.asarray(want[k])
        assert tuple(t.shape) == w.shape, k
        assert _dtype_name(t.dtype) == w.dtype.name, k
        if k in ("tokens", "labels"):
            assert 0 <= int(t.min()) and int(t.max()) < tcfg.vocab, k
        else:
            assert torch.isfinite(t).all() and t.std() > 0.5, k
    again = tcommon.smoke_batch(tcfg, gen=torch.Generator().manual_seed(0))
    other = tcommon.smoke_batch(tcfg, gen=torch.Generator().manual_seed(1))
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert not torch.equal(got["tokens"], other["tokens"])


# ---------------------------------------------------------------------------
# the production rules and the spec trees under them


def _stand_ins(multi: bool):
    """(reference mesh stand-in, port mesh stand-in): the two attributes
    each ``make_rules`` reads."""
    shape, names = tmesh.production_shape(multi_pod=multi)
    jm = types.SimpleNamespace(axis_names=names,
                               devices=np.empty(shape, dtype=object))
    tm = types.SimpleNamespace(mesh_dim_names=names,
                               mesh=torch.empty(shape, device="meta"))
    return jm, tm


def _rules_tuple(r):
    return (dict(r.table), r.fsdp, dict(r.axis_sizes))


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("seq_shard", [False, True])
def test_make_rules_matches_reference(multi, fsdp, seq_shard):
    jm, tm = _stand_ins(multi)
    assert _rules_tuple(tmesh.make_rules(tm, fsdp=fsdp,
                                         seq_shard=seq_shard)) == \
        _rules_tuple(jmesh.make_rules(jm, fsdp=fsdp, seq_shard=seq_shard))


def test_production_mesh_on_a_fake_world():
    """The 256-rank mesh over a fake world: its dims, rank 0's coordinate,
    its rules; the group is gone after."""
    with tmesh.fake_world(256):
        ctx = tmesh.make_production_context(seq_shard=True)
        assert ctx.axis_sizes == {"data": 16, "model": 16}
        assert tuple(ctx.mesh.get_coordinate()) == (0, 0)
        jm, _ = _stand_ins(False)
        assert _rules_tuple(ctx.rules) == _rules_tuple(
            jmesh.make_rules(jm, fsdp=True, seq_shard=True))
    assert not torch.distributed.is_initialized()


def test_smoke_mesh_over_the_first_ranks():
    with tmesh.fake_world(4):
        mesh = tmesh.make_smoke_mesh(2, device="cpu")
        assert mesh.mesh_dim_names == ("data",)
        assert tuple(mesh.mesh.shape) == (2,)
    assert not torch.distributed.is_initialized()


def test_h100_constants_replace_the_tpu_ones():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12 and tmesh.HBM_BYTES == 80e9
    assert tmesh.LINK_BW == 50e9 and tmesh.NVLINK_BW == 450e9
    assert tmesh.SMEM_BYTES == 227 * 1024
    assert not hasattr(tmesh, "VMEM_BYTES") and not hasattr(tmesh, "ICI_BW")


def _jax_leaves(t):
    spec = jax.sharding.PartitionSpec
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_leaves_with_path(
                t, is_leaf=lambda x: isinstance(x, spec))}


def _port_specs(specs, like):
    out = {}

    def walk(t, s, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], s[k], f"{prefix}[{k!r}]")
        else:
            out[prefix] = s

    walk(like, specs, "")
    return out


def _opt(mod):
    jdt = jax.numpy.bfloat16 if mod.OPT_STATE_DTYPE == "bfloat16" \
        else jax.numpy.float32
    return JOptConfig(state_dtype=jdt), dryrun._opt_cfg(mod)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_pspecs_under_production_rules(arch, multi):
    """Leaf for leaf the reference's spec tree of the FULL train state
    (the config's optimizer), and every sharded dim divides its size."""
    mod = tconfigs.get(arch)
    jm, tm = _stand_ins(multi)
    optimizer = getattr(mod, "OPTIMIZER", "adamw")
    want = {k: tuple(v) for k, v in _jax_leaves(jpspecs(
        jbuild(jconfigs.get(arch).FULL), jmesh.make_rules(jm, fsdp=True),
        JTrainConfig(optimizer=optimizer))).items()}
    bundle = tbuild(mod.FULL)
    rules = tmesh.make_rules(tm, fsdp=True)
    tc = dryrun._train_cfg(mod)
    shapes = state_shape_structs(bundle, dryrun._opt_cfg(mod), tc)
    got = _port_specs(train_state_pspecs(bundle, rules, tc), shapes)
    assert got == want
    sizes = dict(rules.axis_sizes)
    for key, leaf in tree.items(shapes):
        spec = got[key]
        for dim, entry in zip(leaf.shape, tuple(spec) + (None,) * 8):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            assert dim % math.prod(sizes[a] for a in axes) == 0, (key, spec)


# ---------------------------------------------------------------------------
# model FLOPs: the reference's model_flops in a subprocess (its module sets
# XLA_FLAGS when imported)

FLOPS_SCRIPT = textwrap.dedent("""
    import json
    from repro import configs
    from repro.configs.common import make_cell
    from repro.launch.dryrun import iter_cells, model_flops
    from repro.models import build
    out = {}
    for arch, shape, skip in iter_cells():
        if not skip:
            cfg = configs.get(arch).FULL
            out[f"{arch} {shape}"] = model_flops(build(cfg),
                                                 make_cell(cfg, shape))
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def reference_model_flops():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", FLOPS_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_model_flops_match_reference(reference_model_flops):
    got = {}
    for arch, shape, skip in dryrun.iter_cells():
        if not skip:
            cfg = tconfigs.get(arch).FULL
            got[f"{arch} {shape}"] = dryrun.model_flops(
                tbuild(cfg), tcommon.make_cell(cfg, shape))
    assert len(got) == 33
    assert got == reference_model_flops


# ---------------------------------------------------------------------------
# the dry run on a fake world of 4 (data=2, model=2)

SMOKE_CELLS = [(a, s) for a in ("llama3.2-1b", "mamba2-1.3b")
               for s in ("train_4k", "prefill_32k", "decode_32k")]


def _smoke_record(arch, shape, dims=(("data", 2), ("model", 2))):
    from torch.distributed.device_mesh import init_device_mesh

    with tmesh.fake_world(math.prod(n for _, n in dims)):
        mesh = init_device_mesh("cpu", tuple(n for _, n in dims),
                                mesh_dim_names=tuple(a for a, _ in dims))
        rec = dryrun.cell_record(arch, shape, "smoke", mesh,
                                 config="smoke")
    assert not torch.distributed.is_initialized()
    return rec


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS)
def test_dryrun_smoke_cells_on_a_2x2_world(arch, shape):
    """Every cell runs. The serve cells run the sharded steps: the prefill
    sums its split compute over model (all-reduce) and, with a KV cache,
    re-lays the cache out to the rank's rows of every KV head
    (all-to-all); the decode sums over model and merges the attention of
    its rows across ranks (all-reduce, all-gather of the row maxima)."""
    rec = _smoke_record(arch, shape)
    if shape != "train_4k":
        assert rec["status"] == "ok", rec.get("reason")
        kinds = set(rec["op_analysis"]["collective_bytes"])
        if shape == "prefill_32k":
            want = {"all-reduce", "all-to-all"} if arch == "llama3.2-1b" \
                else {"all-reduce"}
            assert want <= kinds
            assert ("all-to-all" in kinds) == (arch == "llama3.2-1b")
        else:
            assert {"all-reduce", "all-gather"} <= kinds
            assert "all-to-all" not in kinds
        assert rec["n_chips"] == 4 and rec["fits"]
        return
    assert rec["status"] == "ok"
    assert rec["n_chips"] == 4 and rec["fits"]
    h = rec["op_analysis"]
    assert set(h["collective_bytes"]) >= {"all-gather", "reduce-scatter"}
    assert h["unknown_trip_whiles"] == 0 and h["flops"] > 0
    assert rec["roofline"]["bound_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))
    mem = rec["memory"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]
    # every dispatch op of the model was charged by formula
    ops = set(h["dispatch_ops"])
    assert {"rmsnorm", "reduce"} <= ops
    assert ("ssd" if arch == "mamba2-1.3b" else "attention") in ops


SPLIT_CELLS = [(a, s) for a in ("qwen3-moe-235b-a22b", "seamless-m4t-medium")
               for s in ("train_4k", "prefill_32k", "decode_32k")]


@pytest.mark.parametrize("arch,shape", SPLIT_CELLS)
def test_dryrun_moe_and_encdec_cells_split_on_a_2x2_world(arch, shape):
    """The MoE's and the encoder-decoder's SMOKE cells on the 2x2 world
    trace their split steps: each sums its split compute over model
    (all-reduce; the train cell besides FSDP's all-gather and
    reduce-scatter), and fits."""
    rec = _smoke_record(arch, shape)
    assert rec["status"] == "ok", rec.get("reason")
    kinds = set(rec["op_analysis"]["collective_bytes"])
    assert "all-reduce" in kinds
    if shape == "train_4k":
        assert {"all-gather", "reduce-scatter"} <= kinds
    assert rec["n_chips"] == 4 and rec["fits"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_dryrun_charges_the_tensor_parallel_all_reduces(arch):
    """The 2x2 train cell takes the tensor-parallel step (the model dim
    splits heads, ff and SSM heads): each layer's activations are summed
    over model, forward and backward (SMOKE trains without remat: 4
    all-reduces a layer for llama, 2 for mamba2), each of a rank's rows x
    seq x d in f32, charged twice as collective bytes."""
    cfg = tconfigs.get(arch).SMOKE
    cell = tcommon.make_cell(cfg, "train_4k")
    rec = _smoke_record(arch, "train_4k")
    per_layer = 4 if arch == "llama3.2-1b" else 2
    act = (cell.batch // 2) * cell.seq * cfg.d_model * 4
    got = rec["op_analysis"]["collective_bytes"]["all-reduce"]
    assert got >= 2 * per_layer * cfg.n_layers * act


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_dryrun_argument_bytes_are_rank0_shards(arch):
    """Rank 0's arguments: its shard of every leaf of the reference's train
    state under the reference's 2x2 rules (the rng words stay on the host
    in the port), and its rows of the cell's batch."""
    mod = jconfigs.get(arch)
    jm = types.SimpleNamespace(axis_names=("data", "model"),
                               devices=np.empty((2, 2), dtype=object))
    rules = jmesh.make_rules(jm, fsdp=True)
    sizes = dict(rules.axis_sizes)
    jopt, _ = _opt(tconfigs.get(arch))
    tc = JTrainConfig(optimizer=getattr(mod, "OPTIMIZER", "adamw"))
    bundle = jbuild(mod.SMOKE)
    shapes = _jax_leaves(jshape_structs(bundle, jopt, tc))
    specs = _jax_leaves(jpspecs(bundle, rules, tc))

    def shard_bytes(shape, spec, dtype):
        local = dryrun.local_shape(shape, tuple(spec), sizes)
        return math.prod(local) * np.dtype(dtype).itemsize

    want = sum(shard_bytes(s.shape, specs[k], s.dtype)
               for k, s in shapes.items() if k != "['rng']")
    cell = jcommon.make_cell(mod.SMOKE, "train_4k")
    for k, s in cell.batch_specs.items():
        spec = jspec_for(s.shape, cell.batch_logical[k], rules=rules)
        want += shard_bytes(s.shape, spec, s.dtype)
    rec = _smoke_record(arch, "train_4k")
    assert rec["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_dryrun_serving_cell_on_one_rank(shape):
    """Where the port serves (a mesh that splits nothing), the serve step
    runs under the analyser: the model's dispatch ops charged, no
    collective, the whole cache an argument of the decode step."""
    rec = _smoke_record("llama3.2-1b", shape, (("data", 1), ("model", 1)))
    assert rec["status"] == "ok", rec.get("reason")
    h = rec["op_analysis"]
    assert h["collective_total"] == 0
    # the wave decode's attention over the cache is plain torch
    # (models/xla_attention.py), not a dispatch op
    want = {"attention", "rmsnorm"} if shape == "prefill_32k" \
        else {"rmsnorm"}
    assert set(h["dispatch_ops"]) == want and h["flops"] > 0
    cfg = tconfigs.get("llama3.2-1b").SMOKE
    if shape == "decode_32k":
        kv = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv_heads * cfg.dh * 4
        assert rec["memory"]["argument_bytes"] > kv


def test_dryrun_sharded_decode_never_gathers_the_cache():
    """llama3.2-1b decode_32k at SMOKE on a fake 2x2 world under the
    production rules (``seq_shard``): the rank's cache argument holds its
    data coordinate's 64 of the 128 rows and 1/model of the 32768 cache
    rows, every KV head; the step's collective bytes stay under 5% of
    those cache bytes, so the cache's sequence is never gathered."""
    cfg = tconfigs.get("llama3.2-1b").SMOKE
    rec = _smoke_record("llama3.2-1b", "decode_32k")
    assert rec["status"] == "ok", rec.get("reason")
    cache = 2 * cfg.n_layers * (128 // 2) * (32768 // 2) * cfg.n_kv_heads \
        * cfg.dh * 4
    params = sum(math.prod(ps.shape) for ps in tree.leaves(
        tbuild(cfg).params_pspec)) * 4
    args = rec["memory"]["argument_bytes"]
    # the rank's cache, its part of the params and the 128 tokens
    assert cache < args < cache + params
    assert rec["op_analysis"]["collective_total"] < 0.05 * cache


def test_dryrun_cli_writes_records(tmp_path):
    """The CLI on one cell of the single mesh: the record lands in
    ``<out>/single/<arch>__<shape>.json``; a skipped cell is reported; the
    encoder-decoder's decode cell (a family whose serving once raised
    under the mesh) traces sharded, its self and cross caches' rows split
    over ``model``, and fits the card."""
    dryrun.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                 "--mesh", "single", "--out", str(tmp_path)])
    rec = dryrun.run_cell("llama3.2-1b", "long_500k", "single",
                          str(tmp_path))
    assert rec["status"] == "skip" and "skipped per the brief" in \
        rec["reason"]
    rec = dryrun.run_cell("seamless-m4t-medium", "decode_32k", "single",
                          str(tmp_path))
    assert rec["status"] == "ok" and rec["fits"], rec.get("reason")
    assert {"all-reduce", "all-gather"} <= set(
        rec["op_analysis"]["collective_bytes"])
    path = tmp_path / "single" / "seamless-m4t-medium__decode_32k.json"
    assert json.loads(path.read_text()) == rec
