"""Production-mesh dry run: every (arch x shape x mesh) cell, one rank's
step traced on fake tensors in a fake world.

Counterpart of ``repro.launch.dryrun``. The reference lowers and compiles
each cell for 256 or 512 placeholder devices; here one process plays rank
0 of a 256- or 512-rank world whose collectives return at once
(:func:`repro_torch.launch.mesh.fake_world`), builds the FULL model's state
as fake tensors (shapes and dtypes, nothing allocated) sharded under the
production rules, and runs the port's own step on rank 0's shards under
:class:`~repro_torch.launch.op_analysis.OpAnalyser`. A cell is

  * ``ok``: the step ran; its record holds the rank's memory, FLOPs, HBM
    bytes and collective bytes, the roofline terms on the H100's constants
    and whether the peak fits the card;
  * ``skip``: the config's ``SKIPS`` reason;
  * ``unsupported``: the port raised ``NotImplementedError`` (the message
    is kept): a family without split steps (none is left);
  * anything else fails the cell, and the CLI exits 1.

Train cells take ``make_rules(..., fsdp=True)``, rank 0's shards of
``state_shape_structs`` under ``train_state_pspecs``, and one
``make_train_step(..., mesh_ctx=)`` step: the tensor-parallel step of
every family (a rank's share of the heads, ``ff`` columns, the MoE's
experts or ``e_ff`` columns, SSM heads and vocab, each layer's weights
gathered over ``data`` inside the layer, the activations' all-reduces over
``model`` charged as collective bytes; the MoE's routing groups over the
whole batch). Prefill and decode cells add
``seq_shard`` (the reference's: prefill writes the cache decode reads) and
run ``make_serve_step(bundle, mesh_ctx=)`` on rank 0's part: the
parameters as the sharded engine prepares them (``serving_params``: the
rank's heads, ``ff`` columns, experts or ``e_ff`` columns, SSM heads and
vocab rows, gathered over ``data``), the whole batch (the step takes its
rows; an encoder-decoder's frames too), and for decode the
cache as the rules lay it (``models.lm.local_cache_pspec``: the KV rows
split over ``kv_seq``'s mesh dims, ``model`` for decode_32k, ``data`` x
``model`` for long_500k's one row; an encoder-decoder's self and cross
caches alike). The prefill writes that layout itself
(an all-to-all over ``model``); the decode attends the rank's rows and
merges the partial outputs across ranks, never gathering the cache.

Records go to ``artifacts/dryrun_torch/<mesh>/<arch>__<shape>.json``.

Usage:
  python -m repro_torch.launch.dryrun --all                 # every cell
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import numpy as np
import torch

from repro_torch import configs, tree
from repro_torch.configs.common import SHAPE_TABLE, make_cell
from repro_torch.core import policy as kpolicy
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.op_analysis import OpAnalyser, roofline_terms
from repro_torch.models import build
from repro_torch.models.common import partition_specs, stack_pspec
from repro_torch.models.lm import kv_leaf, local_cache_pspec
from repro_torch.optim import OptConfig
from repro_torch.parallel import sharded_state as shst
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.mesh_context import MeshContext
from repro_torch.parallel.sharding import spec_for
from repro_torch.serving.engine import serving_params
from repro_torch.training import TrainConfig, make_serve_step, make_train_step
from repro_torch.training.train_lib import (
    RNG_WORDS,
    state_shape_structs,
    train_state_pspecs,
)

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
MESHES = {"single": False, "multi": True}
# the dispatch ops' plain forms with the fewest ops to trace: each is
# charged by formula whatever runs it; the SSD's chunked form, not the
# step-by-step oracle
POLICY = "baseline,ssd=fused"


def _opt_cfg(mod) -> OptConfig:
    dt = torch.bfloat16 if mod.OPT_STATE_DTYPE == "bfloat16" \
        else torch.float32
    return OptConfig(state_dtype=dt)


def _train_cfg(mod, microbatches: int = 1) -> TrainConfig:
    return TrainConfig(microbatches=microbatches,
                       optimizer=getattr(mod, "OPTIMIZER", "adamw"))


def model_flops(bundle, cell) -> float:
    """6 N D analytic model FLOPs for the cell (N active for MoE)."""
    n = bundle.n_active_params
    if cell.kind == "train":
        return 6.0 * n * cell.batch * cell.seq
    if cell.kind == "prefill":
        return 2.0 * n * cell.batch * cell.seq
    return 2.0 * n * cell.batch        # decode: one token per sequence


def local_shape(shape, spec, sizes: dict) -> tuple:
    """A tensor's shard shape under ``spec`` on mesh dims of ``sizes``."""
    out = []
    for n, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


def _fake(shape, dtype):
    """A tensor of ``shape`` made under the active ``FakeTensorMode``."""
    return torch.empty(shape, dtype=dtype)


def _shard(meta: torch.Tensor, spec, ctx: MeshContext):
    """Rank 0's shard of a leaf of ``meta``'s shape under ``spec``, a fake
    tensor, as a ``DTensor``."""
    local = _fake(local_shape(meta.shape, spec, ctx.axis_sizes), meta.dtype)
    return shst.dtensor(local, ctx.named_sharding(spec), meta.shape)


def _rows(cell, rules, sizes: dict) -> dict:
    """Rank 0's rows of the cell's inputs, fake tensors."""
    out = {}
    for k, meta in cell.batch_specs.items():
        spec = spec_for(meta.shape, cell.batch_logical[k], rules=rules)
        out[k] = _fake(local_shape(meta.shape, spec, sizes), meta.dtype)
    return out


def _train_args(bundle, mod, ctx: MeshContext, cell):
    """(step, state, batch): rank 0's shards of the train state and rows."""
    opt_cfg, tc = _opt_cfg(mod), _train_cfg(mod)
    shapes = state_shape_structs(bundle, opt_cfg, tc)
    specs = train_state_pspecs(bundle, ctx.rules, tc)

    def place(sub, sub_specs):
        return tree.map_tree(lambda m, s: _shard(m, s, ctx), sub, sub_specs)

    state = {"params": place(shapes["params"], specs["params"]),
             "opt": {"m": place(shapes["opt"]["m"], specs["opt"]["m"]),
                     "v": place(shapes["opt"]["v"], specs["opt"]["v"]),
                     "step": _fake((), torch.int32)},
             "rng": np.array(RNG_WORDS, np.uint32)}
    step = make_train_step(bundle, opt_cfg, tc, mesh_ctx=ctx)
    return step, (state, _rows(cell, ctx.rules, ctx.axis_sizes))


def _serve_args(bundle, ctx: MeshContext, cell):
    """(step, args) of a prefill or decode cell on rank 0."""
    cfg = bundle.cfg
    sharded = tpar.splits(ctx)
    prefill_step, decode_step = make_serve_step(bundle, mesh_ctx=ctx)
    pspec = stack_pspec(bundle.params_pspec)
    p_specs = partition_specs(pspec, rules=ctx.rules, fsdp_ok=True)
    params = tree.map_tree(
        lambda ps, s: _shard(_fake(ps.shape, ps.dtype or cfg.dtype), s, ctx),
        pspec, p_specs)
    # the engine's once-per-run preparation, outside the step
    params = serving_params(params, bundle, ctx)
    # the whole batch: a sharded step takes its rows
    batch = {k: _fake(m.shape, m.dtype) for k, m in cell.batch_specs.items()}
    if cell.kind == "prefill":
        return prefill_step, (params, batch)
    cache_pspec = bundle.cache_pspec(cell.cache_batch, cell.cache_len)
    kv = kv_leaf(cache_pspec)
    if sharded:
        tp = tpar.for_serving(ctx, cfg.dtype, vocab=cfg.vocab,
                              batch=cell.cache_batch, kv=kv)
        cache_pspec = local_cache_pspec(cfg, cache_pspec, tp)
    cache = tree.map_tree(lambda ps: _fake(ps.shape, ps.dtype or cfg.dtype),
                          cache_pspec)
    # the new token's position, the cache's last row (an encoder-decoder's
    # self cache holds half the cell's rows)
    cache["pos"] = (cell.cache_len if kv is None or "attn" in cache_pspec
                    else kv.shape[2]) - 1
    if sharded and kv is not None:
        cache["rows"] = kv.shape[2]
    if sharded and "cross_k" in cache_pspec:
        cache["cross_rows"] = cache_pspec["cross_k"].shape[2]
    return decode_step, (params, cache, batch)


def trace_cell(arch: str, shape: str, ctx: MeshContext, *,
               config: str = "full") -> dict:
    """One cell's step on rank 0 of ``ctx``'s mesh (a process group must be
    up, e.g. :func:`~repro_torch.launch.mesh.fake_world`), traced on fake
    tensors: -> the analysis and the bundle's numbers."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mod = configs.get(arch)
    cfg = mod.FULL if config == "full" else mod.SMOKE
    bundle = build(cfg)
    cell = make_cell(cfg, shape)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            kpolicy.using_policy(POLICY):
        if cell.kind == "train":
            step, args = _train_args(bundle, mod, ctx, cell)
            grad = torch.enable_grad()
        else:
            step, args = _serve_args(bundle, ctx, cell)
            grad = torch.no_grad()
        an = OpAnalyser()
        try:
            with grad, ctx:
                out = an.run(step, *args)
            del out, args
            analysis = an.result()
        finally:
            an.close()
    return {"analysis": analysis, "bundle": bundle, "cell": cell,
            "trace_s": time.time() - t0}


def _context(mesh, shape: str) -> MeshContext:
    # serving cells shard the KV cache sequence dim (prefill writes the
    # cache that decode reads: both sides must agree on its layout)
    seq_shard = SHAPE_TABLE[shape][2] in ("decode", "prefill")
    return MeshContext(mesh=mesh, rules=mesh_lib.make_rules(
        mesh, fsdp=True, seq_shard=seq_shard))


def cell_record(arch: str, shape: str, mesh_name: str, mesh, *,
                config: str = "full") -> dict:
    """The record of one cell on ``mesh`` (its world already up)."""
    base = {"arch": arch, "shape": shape, "mesh": mesh_name}
    ctx = _context(mesh, shape)
    try:
        got = trace_cell(arch, shape, ctx, config=config)
    except NotImplementedError as exc:
        return dict(base, status="unsupported", reason=str(exc))
    h = got["analysis"]
    memory = h.pop("memory")
    n_chips = math.prod(ctx.axis_sizes.values())
    terms = roofline_terms(h, peak_flops=mesh_lib.PEAK_FLOPS_BF16,
                           hbm_bw=mesh_lib.HBM_BW, link_bw=mesh_lib.LINK_BW)
    mf = model_flops(got["bundle"], got["cell"])
    return dict(
        base, status="ok", n_chips=n_chips,
        n_params=got["bundle"].n_params,
        n_active_params=got["bundle"].n_active_params,
        trace_s=round(got["trace_s"], 1), memory=memory,
        fits=memory["peak_bytes"] <= mesh_lib.HBM_BYTES,
        op_analysis=h, roofline=terms, model_flops_global=mf,
        model_flops_per_chip=mf / n_chips,
        useful_flops_ratio=(mf / n_chips) / max(h["flops"], 1.0))


def run_cell(arch: str, shape: str, mesh_name: str, out_dir: str, *,
             force: bool = False) -> dict:
    """One cell of a production mesh, from its artifact when one exists
    (unless ``force``); a fake world of 256 or 512 ranks is started for
    it and destroyed after."""
    mod = configs.get(arch)
    if shape in mod.SKIPS:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skip", "reason": mod.SKIPS[shape]}
    out_path = os.path.join(out_dir, mesh_name, f"{arch}__{shape}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    multi = MESHES[mesh_name]
    dims, _ = mesh_lib.production_shape(multi_pod=multi)
    with mesh_lib.fake_world(math.prod(dims)):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi)
        rec = cell_record(arch, shape, mesh_name, mesh)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def iter_cells():
    for arch in configs.all_arch_ids():
        mod = configs.get(arch)
        for shape in SHAPE_TABLE:
            yield arch, shape, (shape in mod.SKIPS)


def status_line(rec: dict) -> str:
    head = f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:6s}"
    if rec["status"] == "skip":
        return f"skip  {head} ({rec['reason'][:60]})"
    if rec["status"] == "unsupported":
        return f"unsup {head} ({rec['reason'][:90]})"
    r = rec["roofline"]
    return (f"ok    {head} peak={rec['memory']['peak_bytes'] / 2**30:8.2f}GiB"
            f" fits={rec['fits']!s:5s} c={r['compute_s']:.2e}s "
            f"m={r['memory_s']:.2e}s x={r['collective_s']:.2e}s "
            f"dom={r['dominant']} [{rec['trace_s']:.0f}s trace]")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    args = ap.parse_args(argv)

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    if args.all:
        cells = [(a, s) for a, s, _ in iter_cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("pass --all or both --arch and --shape")

    counts = {"ok": 0, "skip": 0, "unsupported": 0, "fail": 0}
    t0 = time.time()
    for arch, shape in cells:
        for mesh_name in meshes:
            try:
                rec = run_cell(arch, shape, mesh_name, args.out,
                               force=args.force)
            except Exception:
                counts["fail"] += 1
                print(f"FAIL  {arch:24s} {shape:12s} {mesh_name}",
                      flush=True)
                traceback.print_exc()
                continue
            counts[rec["status"]] += 1
            print(status_line(rec), flush=True)
    print(f"\n{counts['ok']} ok, {counts['skip']} skip, "
          f"{counts['unsupported']} unsupported, {counts['fail']} fail "
          f"in {time.time() - t0:.1f} s")
    if counts["fail"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
