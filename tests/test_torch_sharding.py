"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's ``repro.parallel.sharding`` on the CPU.

The reference's ``tests/test_sharding.py`` cases against the port's
``spec_for`` entry for entry; every arch's FULL parameter declaration
through the port's ``partition_specs`` against the reference's, leaf by
leaf, under the reference's 16 x 16 rule table (and with FSDP off, and on
the decode caches); ``placements()``/``spec_of`` on a one-process CPU mesh;
``logical_constraint`` and ``param_sharding_tree``.
"""
from __future__ import annotations

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro import configs as rconfigs
from repro.models import build as rbuild
from repro.models.common import partition_specs as rpartition_specs
from repro.parallel.sharding import Rules as RRules
from repro.parallel.sharding import spec_for as rspec_for
from repro_torch import configs as tconfigs
from repro_torch.models import build as tbuild
from repro_torch.models.common import partition_specs, stack_pspec
from repro_torch.parallel import sharding as tsh
from repro_torch.parallel.sharding import Rules, spec_for, use_rules

TABLE = {"batch": ("data",), "heads": "model", "kv_heads": "model",
         "ff": "model", "embed": None, "layers": None, "vocab": "model"}
SIZES = {"data": 16, "model": 16}
# tests/test_sharding.py:72-80, the full-model table
FULL_TABLE = {
    "batch": ("data",), "vocab": "model", "heads": "model",
    "kv_heads": "model", "ff": "model", "e_ff": "model",
    "experts": "model", "inner": "model", "inner_all": "model",
    "ssm_heads": "model", "embed": None, "layers": None,
    "exp_cap": None, "kv_seq": None}

# (shape, logical, table, fsdp, axis_sizes, fsdp_ok): tests/test_sharding.py
SPEC_CASES = {
    "basic_tp": ((2048, 4096), ("embed", "heads"), TABLE, "data", SIZES,
                 False),
    "divisibility_degrades": ((2048, 4), ("embed", "kv_heads"), TABLE,
                              "data", SIZES, False),
    "fsdp_largest_free_dim": ((2048, 4096), ("embed", "heads"), TABLE,
                              "data", SIZES, True),
    "fsdp_skips_used_axis": ((2048, 1600), (None, "ff"),
                             {"batch": ("data",), "ff": "data"}, "data",
                             {"data": 16}, True),
    "axis_never_duplicated": ((64, 64), ("a", "b"),
                              {"a": "model", "b": "model"}, None,
                              {"model": 16}, False),
    "tuple_axes": ((256, 128), ("batch", None),
                   {"batch": ("pod", "data")}, None,
                   {"pod": 2, "data": 16}, False),
    "tuple_axes_degrade": ((24, 128), ("batch", None),
                           {"batch": ("pod", "data")}, None,
                           {"pod": 2, "data": 16}, False),
    "fsdp_no_divisible_dim": ((17, 33), ("embed", None), TABLE, "data",
                              SIZES, True),
    "unnamed_dims": ((8, 8, 8), (None, None, None), TABLE, "data", SIZES,
                     False),
}
EXPECTED = {"basic_tp": (None, "model"),
            "divisibility_degrades": (None, None),
            "fsdp_largest_free_dim": ("data", "model"),
            "fsdp_skips_used_axis": (None, "data"),
            "axis_never_duplicated": ("model", None),
            "tuple_axes": (("pod", "data"), None),
            "tuple_axes_degrade": (None, None)}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_spec_for_matches_reference(case):
    shape, logical, table, fsdp, sizes, fsdp_ok = SPEC_CASES[case]
    got = spec_for(shape, logical, rules=Rules(table=table, fsdp=fsdp,
                                               axis_sizes=sizes),
                   fsdp_ok=fsdp_ok)
    want = rspec_for(shape, logical, rules=RRules(table=table, fsdp=fsdp,
                                                  axis_sizes=sizes),
                     fsdp_ok=fsdp_ok)
    assert got == tuple(want)
    if case in EXPECTED:
        assert got == EXPECTED[case]


def test_no_rules_means_replicated():
    assert spec_for((4, 4), ("batch", "heads"), rules=None) == (None, None)
    assert tuple(rspec_for((4, 4), ("batch", "heads"), rules=None)) == \
        (None, None)


def test_active_rules_scope():
    rules = Rules(table=TABLE, axis_sizes=SIZES)
    assert tsh.current_rules() is None
    with use_rules(rules):
        assert tsh.current_rules() is rules
        assert spec_for((2048, 4096), ("embed", "heads")) == \
            (None, "model")
        with use_rules(None):
            assert spec_for((2048, 4096), ("embed", "heads")) == \
                (None, None)
        assert tsh.current_rules() is rules
    assert tsh.current_rules() is None


def test_spec_length_mismatch_raises():
    with pytest.raises(ValueError):
        spec_for((4, 4), ("embed",), rules=Rules(table=TABLE,
                                                 axis_sizes=SIZES))


def _leaf_specs(tree, prefix=""):
    """{path: spec} over a dict/list tree whose leaves are specs (tuples or
    PartitionSpecs)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaf_specs(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree)}


def _reference_specs(cfg, rules, fsdp_ok):
    return _leaf_specs(jax.tree.map(
        tuple, rpartition_specs(rbuild(cfg).params_pspec, rules=rules,
                                fsdp_ok=fsdp_ok),
        is_leaf=lambda x: isinstance(x, P)))


@pytest.mark.parametrize("arch", rconfigs.all_arch_ids())
def test_partition_specs_match_reference(arch):
    """Every FULL param's spec equals the reference's, leaf by leaf, and
    its axes divide its dims."""
    sizes = {"data": 16, "model": 16}
    rrules = RRules(table=FULL_TABLE, fsdp="data", axis_sizes=sizes)
    trules = Rules(table=FULL_TABLE, fsdp="data", axis_sizes=sizes)
    want = _reference_specs(rconfigs.get(arch).FULL, rrules, True)
    pspec = stack_pspec(tbuild(tconfigs.get(arch).FULL).params_pspec)
    got = _leaf_specs(partition_specs(pspec, rules=trules, fsdp_ok=True))
    assert got == want
    shapes = _leaf_specs(_shapes(pspec))
    for path, spec in got.items():
        for dim, ax in zip(shapes[path], spec):
            if ax is not None:
                axes = (ax,) if isinstance(ax, str) else ax
                size = 1
                for a in axes:
                    size *= sizes[a]
                assert dim % size == 0, (arch, path, spec)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tree.shape


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_partition_specs_without_fsdp_match_reference(arch):
    sizes = {"data": 4, "model": 2}
    rrules = RRules(table=FULL_TABLE, axis_sizes=sizes)
    trules = Rules(table=FULL_TABLE, axis_sizes=sizes)
    want = _reference_specs(rconfigs.get(arch).SMOKE, rrules, False)
    pspec = stack_pspec(tbuild(tconfigs.get(arch).SMOKE).params_pspec)
    assert _leaf_specs(partition_specs(pspec, rules=trules,
                                       fsdp_ok=False)) == want


@pytest.mark.parametrize("arch,kind", [
    ("llama3.2-1b", "ring"), ("llama3.2-1b", "paged"),
    ("mamba2-1.3b", "ring"), ("mamba2-1.3b", "paged"),
    ("zamba2-2.7b", "paged"), ("seamless-m4t-medium", "ring")])
def test_cache_partition_specs_match_reference(arch, kind):
    """The decode caches' logical names: ring and paged KV, Mamba state and
    its snapshot pool, the encoder-decoder's four caches."""
    sizes = {"data": 4, "model": 2}
    rules_r = RRules(table=FULL_TABLE, axis_sizes=sizes)
    rules_t = Rules(table=FULL_TABLE, axis_sizes=sizes)
    rb = rbuild(rconfigs.get(arch).SMOKE)
    tb = tbuild(tconfigs.get(arch).SMOKE)
    if kind == "paged":
        kw = dict(kind="paged", pool_pages=8, page_rows=4, state_pages=4)
        rtree, ttree = (b.cache_pspec(4, 16, True, **kw) for b in (rb, tb))
    else:
        rtree, ttree = rb.cache_pspec(4, 16), tb.cache_pspec(4, 16)
    want = _leaf_specs(jax.tree.map(
        tuple, rpartition_specs(rtree, rules=rules_r, fsdp_ok=False),
        is_leaf=lambda x: isinstance(x, P)))
    got = _leaf_specs(partition_specs(ttree, rules=rules_t, fsdp_ok=False))
    assert got == want


def test_fsdp_shards_big_params_somewhere():
    """ZeRO-3: deepseek-67b's stacked 2-D weights end up sharded over both
    mesh dims (TP x FSDP), as the reference's."""
    rules = Rules(table={"heads": "model", "kv_heads": "model",
                         "ff": "model", "vocab": "model", "embed": None,
                         "layers": None},
                  fsdp="data", axis_sizes={"data": 16, "model": 16})
    pspec = stack_pspec(tbuild(tconfigs.get("deepseek-67b").FULL)
                        .params_pspec)
    specs = _leaf_specs(partition_specs(pspec["blocks"], rules=rules,
                                        fsdp_ok=True))
    big = [s for s in specs.values() if len(s) == 3]
    assert big
    for s in big:
        flat = [a for e in s if e is not None
                for a in ((e,) if isinstance(e, str) else e)]
        assert "data" in flat and "model" in flat, s


@pytest.fixture(scope="module")
def cpu_mesh(tmp_path_factory):
    """A one-process gloo group and a (data=1, model=1) CPU mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        pytest.fail("a process group is already initialised in this worker")
    init = tmp_path_factory.mktemp("gloo") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("spec,want", [
    ((None, "model"), ("R", "S1")),
    (("data", None), ("S0", "R")),
    (("data", "model"), ("S0", "S1")),
    ((("data", "model"), None), ("S0", "S0")),
    ((None, None, None), ("R", "R")),
])
def test_placements_on_a_cpu_mesh(cpu_mesh, spec, want):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    got = tsh.placements(spec, cpu_mesh)
    names = tuple("R" if isinstance(p, Replicate) else f"S{p.dim}"
                  for p in got)
    assert names == want
    assert all(isinstance(p, (Replicate, Shard)) for p in got)
    t = DTensor.from_local(torch.zeros((4,) * len(spec)), cpu_mesh, got,
                           run_check=False)
    # spec_of inverts placements (a dim left unsharded reads back None)
    assert tsh.spec_of(t) == tuple(spec)


def test_placements_reject_reversed_tuple(cpu_mesh):
    with pytest.raises(ValueError, match="order"):
        tsh.placements((("model", "data"),), cpu_mesh)


def test_logical_constraint_on_a_cpu_mesh(cpu_mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.arange(16.0).reshape(4, 4)
    # no rules, or a plain tensor: returned unchanged
    assert tsh.logical_constraint(x, "batch", "heads") is x
    d = DTensor.from_local(x, cpu_mesh, (Replicate(), Replicate()),
                           run_check=False)
    assert tsh.logical_constraint(d, "batch", "heads") is d
    rules = Rules(table={"batch": "data", "heads": "model"},
                  axis_sizes={"data": 1, "model": 1})
    with use_rules(rules):
        assert tsh.logical_constraint(x, "batch", "heads") is x
        got = tsh.logical_constraint(d, "batch", "heads")
    # one-way mesh dims replicate (spec_for needs a size > 1)
    assert got.placements == (Replicate(), Replicate())
    rules2 = Rules(table={"batch": "data", "heads": "model"},
                   axis_sizes={"data": 2, "model": 2})
    with use_rules(rules2):
        got = tsh.logical_constraint(d, "batch", "heads")
    assert got.placements == (Shard(0), Shard(1))
    torch.testing.assert_close(got.full_tensor(), x)


def test_param_sharding_tree_and_count(cpu_mesh):
    from torch.distributed.tensor import Replicate, Shard

    pspec = stack_pspec(tbuild(tconfigs.get("llama3.2-1b").SMOKE)
                        .params_pspec)
    logical = _map_logical(pspec)
    rules = Rules(table=FULL_TABLE, fsdp="data",
                  axis_sizes={"data": 1, "model": 1})
    tree = tsh.param_sharding_tree(pspec, logical, cpu_mesh, rules)
    leaves = list(_leaf_specs(tree).values())
    assert leaves and all(isinstance(p, (Replicate, Shard))
                          for pl in leaves for p in pl)
    rules16 = Rules(table=FULL_TABLE, fsdp="data", axis_sizes=SIZES)
    tree16 = tsh.param_sharding_tree(pspec, logical, cpu_mesh, rules16)
    wq = tree16["blocks"]["attn"]["wq"]           # (layers, embed, heads)
    want = tsh.placements(spec_for(pspec["blocks"]["attn"]["wq"].shape,
                                   ("layers", "embed", "heads"),
                                   rules=rules16, fsdp_ok=True), cpu_mesh)
    assert wq == want
    from repro.parallel.sharding import count_params as rcount
    from repro.models.common import shape_structs

    want_n = rcount(shape_structs(rbuild(rconfigs.get("llama3.2-1b").SMOKE)
                                  .params_pspec))
    assert tsh.count_params(pspec) == want_n


def _map_logical(tree):
    if isinstance(tree, dict):
        return {k: _map_logical(v) for k, v in tree.items()}
    return tree.logical
