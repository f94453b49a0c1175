"""Tensor parallelism of the port's train step (``parallel.tensor_parallel``,
``lm_tp_loss``, ``train_lib.tp_value_and_grad``) against the JAX package on
the CPU.

The reference runs here: its layer functions on whole weights (jitted
``jax.vjp``) and its unsharded ``make_train_step`` for seven SMOKE configs
(f32, ``policy="fused"``, the whole batch), from its own initial states,
carried into numpy.
One module-scoped gloo world of 4 processes (a ``file://`` init in a
temporary directory, as ``tests/test_torch_sharded_train.py``) then runs

* each split module on the ``model`` dim of a ``data=2,model=2`` mesh, its
  weights stored under the rules' specs: ``attn_apply``, ``mlp_apply``,
  ``mamba_apply``, ``split_rmsnorm`` and ``vocab_parallel_cross_entropy``,
  outputs and gradients gathered whole;
* 3 AdamW steps of llama3.2, mamba2, zamba2, danube (its window) and
  internvl2 SMOKE on ``data=2,model=2`` from the reference's state, each
  rank on its data coordinate's rows, recording the shapes of the weights
  each layer function receives;
* the MoE layer on ``data=2,model=2``, each data rank its rows of the
  whole batch, the routing groups laid out over the whole batch:
  ``experts`` over ``model`` (qwen3-moe SMOKE, 8 experts), ``e_ff`` over
  ``model`` (grok-1 SMOKE with 3 experts), experts dropping tokens (a
  capacity of 8, one group a data rank) and one group over both data ranks
  (the rows gathered), against the reference's ``moe_apply_grouped`` on the
  whole batch;
* 3 AdamW steps of qwen3-moe, grok-1 and seamless SMOKE through the same
  tensor-parallel route;
* llama3.2 on ``model=4`` (2 KV heads, one a rank pair), with the KV
  projections stored split (half a head a rank) and replicated;
* qwen3-moe and seamless SMOKE on ``data=4`` from the reference's state,
  the gather-whole step of a mesh without a ``model`` dim, beside the
  reference's unsharded step on the whole batch.

Each test reads one result.
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

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.models import layers as jlayers
from repro.optim import OptConfig as JOptConfig
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as jinit_train_state
from repro.training import make_train_step as jmake_train_step

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300          # seconds, the world
ARCHS = ("llama3.2-1b", "mamba2-1.3b", "zamba2-2.7b", "h2o-danube-3-4b",
         "internvl2-76b", "qwen3-moe-235b-a22b", "seamless-m4t-medium",
         "grok-1-314b")
# also trained through the gather-whole step on data=4
OTHERS = ("qwen3-moe-235b-a22b", "seamless-m4t-medium")
# the MoE layer cases: (arch, changes to its SMOKE config); each runs on
# the whole batch of MOE_B x MOE_S tokens, MOE_AUX times its aux loss added
# to the objective
MOE_CASES = {
    "experts": ("qwen3-moe-235b-a22b", {}),
    "e_ff": ("grok-1-314b", {"n_experts": 3}),
    "drop": ("qwen3-moe-235b-a22b", {"capacity_factor": 0.05,
                                     "moe_groups": 2}),
    "gather": ("qwen3-moe-235b-a22b", {"moe_groups": 1}),
}
MOE_B, MOE_S, MOE_AUX = 4, 16, 3.0
BATCH, SEQ, STEPS = 4, 16, 3
# danube's window (32) inside the sequence: a longer one for it
SEQS = {"h2o-danube-3-4b": 40}
OPT = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
MB, MS = 2, 16                       # the module cases' batch and sequence


def _np_tree(t) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(t)}


def _jcfg(arch: str):
    return dataclasses.replace(jconfigs.get(arch).SMOKE, policy="fused")


def _batch(arch: str, rng) -> dict:
    cfg = jconfigs.get(arch).SMOKE
    seq = SEQS.get(arch, SEQ)
    tok = rng.integers(1, cfg.vocab, size=(BATCH, seq + 1), dtype=np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    if cfg.stub_tokens:
        out["stub"] = rng.standard_normal(
            (BATCH, cfg.stub_tokens, cfg.stub_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (BATCH, seq, cfg.d_model)).astype(np.float32)
    return out


# ---------------------------------------------------------------------------
# the reference's modules on whole weights


def _weights(rng, shapes: dict) -> dict:
    out = {}
    for k, shp in shapes.items():
        if k == "dt_bias":
            out[k] = np.log(np.expm1(rng.uniform(1e-3, 1e-1, shp)))
        elif k == "a_log":
            out[k] = np.log(rng.uniform(1.0, 16.0, shp))
        elif k in ("d_skip", "norm_w"):
            out[k] = 1.0 + 0.1 * rng.standard_normal(shp)
        else:
            out[k] = rng.standard_normal(shp) / np.sqrt(shp[0])
    return {k: v.astype(np.float32) for k, v in out.items()}


def _module_refs(d: Path) -> None:
    """Inputs, cotangents, outputs and gradients of each module case."""
    rng = np.random.default_rng(7)
    z = {}
    pos = jnp.broadcast_to(jnp.arange(MS), (MB, MS))
    cases = {
        "attn": ("llama3.2-1b", {
            "wq": (64, 64), "wk": (64, 32), "wv": (64, 32), "wo": (64, 64)},
            lambda p, x, cfg: jlayers.attn_apply(p, cfg, x,
                                                 positions=pos)[0]),
        "mlp": ("llama3.2-1b", {
            "w_in": (64, 128), "w_gate": (64, 128), "w_out": (128, 64)},
            lambda p, x, cfg: jlayers.mlp_apply(p, cfg, x)),
        "mamba": ("mamba2-1.3b", {
            "in_proj": (64, 296), "conv_w": (4, 160), "conv_b": (160,),
            "dt_bias": (8,), "a_log": (8,), "d_skip": (8,),
            "norm_w": (128,), "out_proj": (128, 64)},
            lambda p, x, cfg: jlayers.mamba_apply(p, cfg, x)[0]),
    }
    for name, (arch, shapes, fn) in cases.items():
        cfg = _jcfg(arch)
        p = _weights(rng, shapes)
        x = rng.standard_normal((MB, MS, cfg.d_model)).astype(np.float32)
        ct = rng.standard_normal(x.shape).astype(np.float32)

        @jax.jit
        def value_and_vjp(p, x, ct, fn=fn, cfg=cfg):
            out, vjp = jax.vjp(lambda p, x: fn(p, x, cfg), p, x)
            return out, vjp(ct)

        out, (gp, gx) = value_and_vjp(p, x, ct)
        z.update({f"{name}.x": x, f"{name}.ct": ct,
                  f"{name}.out": np.asarray(out),
                  f"{name}.gx": np.asarray(gx)})
        for k in shapes:
            z[f"{name}.p.{k}"] = p[k]
            z[f"{name}.g.{k}"] = np.asarray(gp[k])
    # the gated norm over d_inner 128, and the cross-entropy over vocab 256
    x = rng.standard_normal((MB, MS, 128)).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    out, vjp = jax.vjp(lambda x, w: jcommon.rmsnorm(x, w, 1e-5), x, w)
    ct = rng.standard_normal(out.shape).astype(np.float32)
    gx, gw = vjp(jnp.asarray(ct))
    z.update({"norm.x": x, "norm.w": w, "norm.ct": ct,
              "norm.out": np.asarray(out), "norm.gx": np.asarray(gx),
              "norm.gw": np.asarray(gw)})
    logits = (3.0 * rng.standard_normal((MB, MS, 256))).astype(np.float32)
    labels = rng.integers(0, 256, size=(MB, MS)).astype(np.int32)
    loss, vjp = jax.vjp(lambda lg: jcommon.cross_entropy(lg, labels), logits)
    z.update({"ce.logits": logits, "ce.labels": labels,
              "ce.loss": np.asarray(loss),
              "ce.g": np.asarray(vjp(jnp.float32(1.0))[0])})
    for name, (arch, changes) in MOE_CASES.items():
        cfg = dataclasses.replace(_jcfg(arch), **changes)
        dm, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
        # fan-in scaled, as the model's own init (shape[-2])
        p = {k: (rng.standard_normal(shp) / np.sqrt(shp[-2]))
             .astype(np.float32) for k, shp in (
                 ("router", (dm, e)), ("w_in", (e, dm, f)),
                 ("w_gate", (e, dm, f)), ("w_out", (e, f, dm)))}
        x = rng.standard_normal((MOE_B, MOE_S, dm)).astype(np.float32)
        ct = rng.standard_normal(x.shape).astype(np.float32)

        @jax.jit
        def value_and_vjp(p, x, ct, cfg=cfg):
            def obj(p, x):
                out, aux = jlayers.moe_apply_grouped(p, cfg, x)
                return jnp.sum(out * ct) + MOE_AUX * aux, (out, aux)
            (_, (out, aux)), grads = jax.value_and_grad(
                obj, argnums=(0, 1), has_aux=True)(p, x)
            return out, aux, grads

        out, aux, (gp, gx) = value_and_vjp(p, x, ct)
        # the same layer on each data coordinate's half of the rows, as the
        # port's data-parallel step once routed: its mean aux
        halves = [jlayers.moe_apply_grouped(p, cfg, x[i:i + MOE_B // 2])[1]
                  for i in (0, MOE_B // 2)]
        # the routed slots past capacity of the whole batch's groups
        g = np.gcd(MOE_B * MOE_S, cfg.moe_groups)
        logits = x.reshape(g, -1, dm) @ p["router"]
        top = np.argsort(-logits, axis=-1,
                         kind="stable")[..., :cfg.experts_per_tok]
        counts = np.stack([np.bincount(t.reshape(-1), minlength=e)
                           for t in top])
        n = top[0].size
        cap = max(8, int(cfg.capacity_factor * n / e + 127) // 128 * 128)
        z.update({f"moe_{name}.x": x, f"moe_{name}.ct": ct,
                  f"moe_{name}.out": np.asarray(out),
                  f"moe_{name}.aux": np.asarray(aux),
                  f"moe_{name}.aux_halves": np.float32(
                      np.mean([float(a) for a in halves])),
                  f"moe_{name}.dropped": np.int64(
                      np.maximum(counts - cap, 0).sum()),
                  f"moe_{name}.gx": np.asarray(gx)})
        for k in p:
            z[f"moe_{name}.p.{k}"] = p[k]
            z[f"moe_{name}.g.{k}"] = np.asarray(gp[k])
    np.savez(d / "modules.npz", **z)


# ---------------------------------------------------------------------------
# the world

WORKER = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "init"), rank=rank, world_size=world)
import dataclasses
from repro_torch import configs, tree
from repro_torch.models import build, lm
from repro_torch.models import layers as L
from repro_torch.models.common import partition_specs
from repro_torch.optim import OptConfig
from repro_torch.parallel import make_context
from repro_torch.parallel import tensor_parallel as tpar
from repro_torch.parallel.mesh_context import DEFAULT_RULE_TABLE
from repro_torch.parallel.sharded_state import full_tensor, gather_full, \\
    place
from repro_torch.training import (init_train_state, make_train_step,
                                  shard_train_state)

torch.manual_seed(0)
opt_cfg = OptConfig(**json.loads(sys.argv[4]))
out, info = {}, {}
ctx = make_context("data=2,model=2", device="cpu")
coord = dict(zip(ctx.mesh.mesh_dim_names, ctx.mesh.get_coordinate()))
z = np.load(os.path.join(d, "modules.npz"))
T = lambda k: torch.from_numpy(z[k])


def split(name, pspec, cfg, fn, takes):
    # a module's weights stored under the rules' specs, its view per rank
    specs = partition_specs(pspec, rules=ctx.rules, fsdp_ok=False)
    whole = {k: T(f"{name}.p.{k}") for k in specs}
    locs = {k: place(whole[k], ctx.named_sharding(specs[k])).to_local()
            .requires_grad_() for k in specs}
    x = T(f"{name}.x").requires_grad_()
    tp = tpar.TensorParallel(mesh=ctx.mesh, dtype=torch.float32,
                             vocab_split=True)
    with tpar.active(tp):
        p = tp.views({k: tpar.Shard(locs[k], specs[k]) for k in specs},
                     takes(cfg, tp))
        y = fn(p, x, cfg)
        got = torch.autograd.grad((y * T(f"{name}.ct")).sum(),
                                  [x] + list(locs.values()))
    out[f"{name}.out"] = y.detach().numpy()
    out[f"{name}.gx"] = got[0].numpy()
    for (k, g) in zip(specs, got[1:]):
        out[f"{name}.g.{k}"] = gather_full(g, specs[k], ctx.mesh).numpy()
    info[f"{name}.specs"] = {k: str(v) for k, v in specs.items()}


def pieces(name, cfg, fn):
    # each rank's columns of the last dim in, its columns out, gathered
    tp = tpar.TensorParallel(mesh=ctx.mesh, dtype=torch.float32,
                             vocab_split=True)
    lo, hi = tp.span(z[name].shape[-1])
    return tp, lo, hi


llama = dataclasses.replace(configs.get("llama3.2-1b").SMOKE)
mamba = dataclasses.replace(configs.get("mamba2-1.3b").SMOKE)
pos = torch.arange(16).expand(2, 16)
split("attn", L.attn_pspec(llama), llama,
      lambda p, x, c: L.attn_apply(p, c, x, positions=pos)[0], L.attn_takes)
split("mlp", L.mlp_pspec(llama), llama,
      lambda p, x, c: L.mlp_apply(p, c, x), L.mlp_takes)
split("mamba", L.mamba_pspec(mamba), mamba,
      lambda p, x, c: L.mamba_apply(p, c, x)[0], L.mamba_takes)

tp, lo, hi = pieces("norm.x", mamba, None)
x = T("norm.x")[..., lo:hi].clone().requires_grad_()
w = T("norm.w")[lo:hi].clone().requires_grad_()
with tpar.active(tp):
    y = tpar.split_rmsnorm(x, w, 1e-5, 128, tp)
    gx, gw = torch.autograd.grad((y * T("norm.ct")[..., lo:hi]).sum(), [x, w])
for k, v in (("out", y.detach()), ("gx", gx), ("gw", gw)):
    parts = [torch.zeros_like(v) for _ in range(2)]
    dist.all_gather(parts, v.contiguous(), group=ctx.mesh.get_group("model"))
    out[f"norm.{k}"] = torch.cat(parts, dim=-1).numpy()

tp, lo, hi = pieces("ce.logits", llama, None)
lg = T("ce.logits")[..., lo:hi].clone().requires_grad_()
with tpar.active(tp):
    loss = tpar.vocab_parallel_cross_entropy(lg, T("ce.labels"), tp)
    (g,) = torch.autograd.grad(loss, [lg])
parts = [torch.zeros_like(g) for _ in range(2)]
dist.all_gather(parts, g.contiguous(), group=ctx.mesh.get_group("model"))
out["ce.loss"] = loss.detach().numpy()
out["ce.g"] = torch.cat(parts, dim=-1).numpy()

# the MoE layer: each data rank its rows, the groups of the whole batch;
# the objective P x (out . ct) + MOE_AUX x aux a rank, whose mean over the
# P data ranks (the views' gradients) is the reference's on the whole batch
from repro_torch.core.distributed import all_reduce_sum
P = ctx.axis_sizes["data"]
rows = ("data", None, None)
for name, (arch, changes) in MOE_CASES.items():
    cfg = dataclasses.replace(configs.get(arch).SMOKE, **changes)
    specs = partition_specs(L.moe_pspec(cfg), rules=ctx.rules, fsdp_ok=False)
    locs = {k: place(T(f"moe_{name}.p.{k}"), ctx.named_sharding(specs[k]))
            .to_local().requires_grad_() for k in specs}
    n = MOE_B // P
    lo = coord["data"] * n
    x = T(f"moe_{name}.x")[lo:lo + n].clone().requires_grad_()
    tp = tpar.TensorParallel(mesh=ctx.mesh, dtype=torch.float32,
                             batch_axes=("data",))
    with tpar.active(tp):
        p = tp.views({k: tpar.Shard(locs[k], specs[k]) for k in specs},
                     L.moe_takes(cfg, tp))
        y, aux = L.moe_apply(p, cfg, x)
        obj = P * (y * T(f"moe_{name}.ct")[lo:lo + n]).sum() + MOE_AUX * aux
        got = torch.autograd.grad(obj, [x] + list(locs.values()))
    out[f"moe_{name}.out"] = gather_full(y.detach(), rows, ctx.mesh).numpy()
    out[f"moe_{name}.aux"] = (all_reduce_sum(aux.detach(), (ctx.mesh, "data"))
                              / P).numpy()
    out[f"moe_{name}.gx"] = gather_full(got[0], rows, ctx.mesh).numpy() / P
    for k, g in zip(specs, got[1:]):
        out[f"moe_{name}.g.{k}"] = gather_full(g, specs[k], ctx.mesh).numpy()
    info[f"moe_{name}.specs"] = {k: str(v) for k, v in specs.items()}
    info[f"moe_{name}.local"] = {k: list(v.shape) for k, v in p.items()}


def whole_state(arch, bundle):
    zs = np.load(os.path.join(d, f"state0_{arch}.npz"))
    tmpl = init_train_state(torch.Generator().manual_seed(1), bundle,
                            opt_cfg)
    return tree.unflatten(tmpl, [
        zs[k] if isinstance(leaf, np.ndarray) else torch.from_numpy(zs[k])
        for k, leaf in tree.items(tmpl)])


def seen_shapes():
    # the shapes of the weights each layer function is given, first call
    seen = {}

    def wrap(mod, name):
        fn = getattr(mod, name)

        def rec(p, *a, **k):
            shp = {kk: list(v.shape) for kk, v in p.items()} \\
                if isinstance(p, dict) else list(p.shape)
            seen.setdefault(name, shp)
            return fn(p, *a, **k)
        setattr(mod, name, rec)
        return (mod, name, fn)
    undo = [wrap(L, "attn_apply"), wrap(L, "mlp_apply"),
            wrap(L, "mamba_apply"), wrap(L, "moe_apply"),
            wrap(lm, "embed_tokens")]
    return seen, undo


def run(arch, mctx, batch, tag, state, record=False):
    bundle = build(configs.get(arch).SMOKE)
    n = batch["tokens"].shape[0] // mctx.axis_sizes.get("data", 1)
    c = dict(zip(mctx.mesh.mesh_dim_names, mctx.mesh.get_coordinate()))
    lo = c.get("data", 0) * n
    mine = {k: v[lo:lo + n] for k, v in batch.items()}
    sh = shard_train_state(state, bundle, mctx)
    step = make_train_step(bundle, opt_cfg, mesh_ctx=mctx)
    if record:
        seen, undo = seen_shapes()
    losses = []
    for i in range(3):
        sh, m = step(sh, mine)
        losses.append(float(m["loss"]))
        if i == 0:
            if record:
                for mod, name, fn in undo:
                    setattr(mod, name, fn)
                info[tag + ".seen"] = seen
            for k, leaf in tree.items(sh["params"]):
                out[tag + ".after1" + k] = full_tensor(leaf).numpy()
    info[tag + ".losses"] = losses
    info[tag + ".split"] = sorted(step.split)


ctx_data = make_context("data=4", device="cpu")
for arch in ARCHS:
    zb = np.load(os.path.join(d, f"batch_{arch}.npz"))
    batch = {k: torch.from_numpy(zb[k]).long() if k in ("tokens", "labels")
             else torch.from_numpy(zb[k]) for k in zb.files}
    bundle = build(configs.get(arch).SMOKE)
    run(arch, ctx, batch, arch, state=whole_state(arch, bundle),
        record=arch in ("llama3.2-1b", "mamba2-1.3b", "qwen3-moe-235b-a22b"))
    if arch in OTHERS:      # the gather-whole step, a row a rank
        run(arch, ctx_data, batch, "whole/" + arch,
            state=whole_state(arch, bundle))

# remat's recompute on another thread (where autograd runs a CUDA
# backward), which the step's context does not reach: the same gradients
import threading
from repro_torch.parallel.sharding import spec_of
from repro_torch.training.train_lib import batch_mesh_axes
cfg = dataclasses.replace(configs.get("llama3.2-1b").SMOKE,
                          remat_policy="none")
bundle = build(cfg)
zb = np.load(os.path.join(d, "batch_llama3.2-1b.npz"))
batch = {k: torch.from_numpy(zb[k]).long()[2 * coord["data"]:][:2]
         for k in zb.files}
sh = shard_train_state(whole_state("llama3.2-1b", bundle), bundle, ctx)
flat = tree.leaves(sh["params"])
tp = tpar.TensorParallel(mesh=ctx.mesh, dtype=torch.float32,
                         vocab_split=True, batch_axes=batch_mesh_axes(ctx))
grads = {}
for where in ("here", "thread"):
    locs = [p.to_local().detach().requires_grad_() for p in flat]
    with tpar.active(tp):
        loss = bundle.tp_loss(tree.unflatten(sh["params"], [
            tpar.Shard(t, spec_of(p)) for t, p in zip(locs, flat)]), batch)
        backward = lambda: grads.setdefault(where,
                                            torch.autograd.grad(loss, locs))
        if where == "here":        # as the step does, inside its context
            backward()
        else:
            t = threading.Thread(target=backward)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive(), "the backward's thread did not end"
info["recompute_in_thread"] = max(
    float((a - b).abs().max()) for a, b in zip(grads["here"],
                                                grads["thread"]))

# model=4, two KV heads: the KV projections stored split and replicated
zb = np.load(os.path.join(d, "batch_llama3.2-1b.npz"))
batch = {k: torch.from_numpy(zb[k]).long() for k in zb.files}
bundle = build(configs.get("llama3.2-1b").SMOKE)
for tag, table in (("m4", None),
                   ("m4_kv_replicated", dict(DEFAULT_RULE_TABLE,
                                             kv_heads=None))):
    ctx4 = make_context("model=4", device="cpu", table=table)
    run("llama3.2-1b", ctx4, batch, tag,
        state=whole_state("llama3.2-1b", bundle))
    sh = shard_train_state(whole_state("llama3.2-1b", bundle), bundle, ctx4)
    info[tag + ".wk_spec"] = str(sh["params"]["blocks"]["attn"]["wk"]
                                 .placements)

np.savez(os.path.join(d, f"r{rank}.npz"), **out)
with open(os.path.join(d, f"r{rank}.json"), "w") as f:
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


def _start_world(size: int, d: Path) -> list:
    script = (f"ARCHS = {ARCHS!r}\nOTHERS = {OTHERS!r}\n"
              f"MOE_CASES = {MOE_CASES!r}\nMOE_B = {MOE_B!r}\n"
              f"MOE_AUX = {MOE_AUX!r}\n" + textwrap.dedent(WORKER))
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(size), str(d),
         json.dumps(OPT)], cwd=ROOT, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(size)]


def _wait_world(procs: list) -> None:
    size = len(procs)
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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tensor_parallel")
    _module_refs(d)
    rng = np.random.default_rng(0)
    jopt = JOptConfig(policy="fused", **OPT)
    start = {}
    for arch in ARCHS:
        batch = _batch(arch, rng)
        np.savez(d / f"batch_{arch}.npz", **batch)
        jbundle = jbuild(_jcfg(arch))
        state = jinit_train_state(jax.random.PRNGKey(0), jbundle, jopt)
        np.savez(d / f"state0_{arch}.npz", **_np_tree(state))
        start[arch] = (jbundle, state, batch)
    procs = _start_world(4, d)
    # the reference's steps while the world runs: unsharded, on the whole
    # batch (the MoE routes the groups of every row)
    ref = {}
    for arch, (jbundle, state, batch) in start.items():
        jstep = jax.jit(jmake_train_step(jbundle, jopt, JTrainConfig()))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        losses = []
        for i in range(STEPS):
            state, m = jstep(state, jb)
            losses.append(float(m["loss"]))
            if i == 0:
                after1 = _np_tree(state)
        ref[arch] = {"losses": losses, "after1": after1}
    _wait_world(procs)
    ranks = [(dict(np.load(d / f"r{r}.npz")),
              json.loads((d / f"r{r}.json").read_text())) for r in range(4)]
    return {"ref": ref, "ranks": ranks,
            "modules": dict(np.load(d / "modules.npz"))}


# ---------------------------------------------------------------------------
# the modules


def _grad_close(got, want, what: str) -> None:
    """tests/test_torch_training.py's SSD gradient tolerance: rtol 1e-4 and
    an atol of 1e-6 of the largest element."""
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-6 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", ["attn", "mlp", "mamba"])
def test_split_layer_matches_reference(world, name):
    """The layer split over model=2 (weights under the rules' specs, each
    rank its heads or ff columns) against the reference's on the whole
    weights: output within 1e-5, the input's and every weight's gradient
    (gathered whole) within the SSD gradient tolerance of
    tests/test_torch_training.py; every rank alike."""
    want = world["modules"]
    for arrs, _ in world["ranks"]:
        np.testing.assert_allclose(arrs[f"{name}.out"], want[f"{name}.out"],
                                   rtol=0, atol=1e-5)
        for k in [k for k in want if k.startswith(f"{name}.g")]:
            _grad_close(arrs[k], want[k], k)
    specs = world["ranks"][0][1][f"{name}.specs"]
    assert "'model'" in "".join(specs.values())       # stored split


def test_split_rmsnorm_matches_reference(world):
    """RMSNorm over 128 columns, 64 a rank: output within 1e-5 of
    ``repro.models.common.rmsnorm``, its gradients within the SSD gradient
    tolerance."""
    want = world["modules"]
    for arrs, _ in world["ranks"]:
        np.testing.assert_allclose(arrs["norm.out"], want["norm.out"],
                                   rtol=0, atol=1e-5)
        for k in ("norm.gx", "norm.gw"):
            _grad_close(arrs[k], want[k], k)


def test_vocab_parallel_cross_entropy_matches_reference(world):
    """Cross-entropy over 256 logits, 128 a rank: the loss within 1e-5 of
    ``repro.models.common.cross_entropy``, the logits' gradient within the
    SSD gradient tolerance."""
    want = world["modules"]
    for arrs, _ in world["ranks"]:
        np.testing.assert_allclose(arrs["ce.loss"], want["ce.loss"], rtol=0,
                                   atol=1e-5)
        _grad_close(arrs["ce.g"], want["ce.g"], "ce.g")


# ---------------------------------------------------------------------------
# the whole step


def _first_step_bound(got: dict, tag: str, after1: dict) -> None:
    """tests/test_torch_sharded_train.py's bound on the params after the
    first step against the reference's: rtol 1e-5, atol 1e-6, plus what
    AdamW's first update adds where the gradients may differ."""
    lr, eps = OPT["peak_lr"], 1e-8
    n = 0
    for key, want in after1.items():
        if not key.startswith("['params']"):
            continue
        g = np.abs(after1["['opt']['m']" + key[len("['params']"):]]
                   .astype(np.float64)) / (1 - 0.9)
        dg = 1e-4 * g + 1e-6
        slack = lr * np.minimum(
            2.0, eps * dg / (np.maximum(g - dg, 0.0) + eps) ** 2)
        err = np.abs(got[tag + ".after1" + key[len("['params']"):]]
                     .astype(np.float64) - want)
        bound = 1e-6 + 1e-5 * np.abs(want) + slack
        assert np.all(err <= bound), (tag, key, float(np.max(err - bound)))
        n += 1
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_split_step_matches_reference(world, arch):
    """3 AdamW steps on data=2,model=2 through the tensor-parallel route
    (the MoE's experts and seamless's encoder, decoder and cross-attention
    heads split too): the same losses on every rank, within 1e-5 of the
    reference's unsharded step on the whole batch from the same state, the
    params after the first step within the first-step bound, and the
    step's parts timed."""
    infos = [info for _, info in world["ranks"]]
    losses = infos[0][arch + ".losses"]
    for info in infos[1:]:
        assert info[arch + ".losses"] == losses
    np.testing.assert_allclose(losses, world["ref"][arch]["losses"], rtol=0,
                               atol=1e-5)
    assert infos[0][arch + ".split"] == [
        "forward_backward", "gather", "reduce_scatter", "tp_all_reduce",
        "update"]
    for arrs, _ in world["ranks"]:
        _first_step_bound(arrs, arch, world["ref"][arch]["after1"])


@pytest.mark.parametrize("tag", ["m4", "m4_kv_replicated"])
def test_shared_kv_heads_over_model_4(world, tag):
    """llama3.2 SMOKE on model=4: 4 query heads, one a rank, and 2 KV
    heads, each read by two ranks. Stored split (half a head a rank, the
    default rules) or replicated (``kv_heads`` unmapped), the rank takes its
    group's head whole and ``wk``/``wv``'s gradients are summed over
    model: losses and first-step params against the reference's."""
    infos = [info for _, info in world["ranks"]]
    assert ("Shard" in infos[0][tag + ".wk_spec"]) == (tag == "m4")
    np.testing.assert_allclose(infos[0][tag + ".losses"],
                               world["ref"]["llama3.2-1b"]["losses"], rtol=0,
                               atol=1e-5)
    for arrs, _ in world["ranks"]:
        _first_step_bound(arrs, tag, world["ref"]["llama3.2-1b"]["after1"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b",
                                  "qwen3-moe-235b-a22b"])
def test_forward_holds_no_split_leaf_whole(world, arch):
    """The weights each layer function receives on model=2: the rank's
    heads' columns (``wq``, ``wo``), its KV head, its ``ff`` columns, its
    experts (the router whole), its SSM heads' ``in_proj``/conv columns
    with B and C whole, its vocab rows; never a model-split leaf whole."""
    cfg = jconfigs.get(arch).SMOKE
    d, m = cfg.d_model, 2
    seen = world["ranks"][0][1][arch + ".seen"]
    assert seen["embed_tokens"] == [cfg.vocab // m, d]
    if cfg.family == "moe":
        e, f = cfg.n_experts, cfg.moe_d_ff
        assert seen["moe_apply"] == {
            "router": [d, e], "w_in": [e // m, d, f],
            "w_gate": [e // m, d, f], "w_out": [e // m, f, d]}
        assert seen["attn_apply"]["wq"] == [d, cfg.n_heads // m
                                            * cfg.head_dim]
        return
    if arch == "llama3.2-1b":
        dh = cfg.head_dim
        hq, hkv = cfg.n_heads // m, cfg.n_kv_heads // m
        assert seen["attn_apply"] == {
            "wq": [d, hq * dh], "wk": [d, hkv * dh], "wv": [d, hkv * dh],
            "wo": [hq * dh, d]}
        f = cfg.d_ff // m
        assert seen["mlp_apply"] == {"w_in": [d, f], "w_gate": [d, f],
                                     "w_out": [f, d]}
        return
    di, ns = cfg.expand * d // m, cfg.ssm_state
    hh = cfg.expand * d // cfg.ssm_head_dim // m
    whole = 2 * cfg.expand * d + 2 * ns + 2 * hh
    got = seen["mamba_apply"]
    assert got == {"in_proj": [d, 2 * di + 2 * ns + hh],
                   "conv_w": [cfg.conv_kernel, di + 2 * ns],
                   "conv_b": [di + 2 * ns], "dt_bias": [hh], "a_log": [hh],
                   "d_skip": [hh], "norm_w": [di], "out_proj": [di, d]}
    assert got["in_proj"][1] < whole


def test_recomputed_layer_gathers_and_splits_off_the_step_thread(world):
    """llama3.2 SMOKE under remat ``none``: the backward on a thread of its
    own (as autograd runs a CUDA backward, on a device thread the step's
    context does not reach) recomputes each layer split and gathered as in
    the forward: its gradients equal those of a backward on the step's
    thread, on every rank."""
    for _, info in world["ranks"]:
        assert info["recompute_in_thread"] == 0.0


@pytest.mark.parametrize("arch", OTHERS)
def test_moe_and_encdec_keep_the_gather_whole_step(world, arch):
    """qwen3-moe and seamless on data=4 (a mesh without a ``model`` dim, a
    row a rank) take the gather-whole step (no activation all-reduce part),
    with the same losses on every rank, within 1e-5 of the reference's
    unsharded step over the whole batch (the MoE routes the whole batch's
    groups: a rank its 8 of the 32) from the same state, and the params
    after the first step within the first-step bound."""
    tag = "whole/" + arch
    infos = [info for _, info in world["ranks"]]
    losses = infos[0][tag + ".losses"]
    for info in infos[1:]:
        assert info[tag + ".losses"] == losses
    assert infos[0][tag + ".split"] == ["forward_backward", "gather",
                                        "reduce_scatter", "update"]
    np.testing.assert_allclose(losses, world["ref"][arch]["losses"], rtol=0,
                               atol=1e-5)
    for arrs, _ in world["ranks"]:
        _first_step_bound(arrs, tag, world["ref"][arch]["after1"])


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_layer_split_matches_reference(world, name):
    """The MoE layer on data=2,model=2, each data rank its half of the 4 x
    16 tokens, against the reference's ``moe_apply_grouped`` on the whole
    batch: output within 1e-5, the aux loss (the data ranks' mean) within
    1e-5, the input's and every weight's gradient, the router's included,
    within the SSD gradient tolerance of tests/test_torch_training.py
    (objective: the outputs against a cotangent plus 3 aux). ``experts``:
    qwen3-moe's 8 experts, 4 a rank; ``e_ff``: 3 experts, which 2 does not
    divide, each rank every expert's half of the 128 ``e_ff`` columns;
    ``drop``: one group a data rank whose experts drop tokens; ``gather``:
    one group over both data ranks' rows."""
    want = world["modules"]
    arch, changes = MOE_CASES[name]
    cfg = dataclasses.replace(jconfigs.get(arch).SMOKE, **changes)
    key = f"moe_{name}"
    for arrs, info in world["ranks"]:
        np.testing.assert_allclose(arrs[key + ".out"], want[key + ".out"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(arrs[key + ".aux"], want[key + ".aux"],
                                   rtol=0, atol=1e-5)
        for k in [k for k in want if k.startswith(key + ".g")]:
            _grad_close(arrs[k], want[k], k)
        e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        local = info[key + ".local"]
        assert local["router"] == [d, e]
        if e % 2 == 0:
            assert local["w_in"] == [e // 2, d, f]
            assert local["w_out"] == [e // 2, f, d]
        else:
            assert local["w_in"] == [e, d, f // 2]
            assert local["w_out"] == [e, f // 2, d]


def test_moe_cases_hold_the_faults_they_guard(world):
    """The cases are ones where a wrong layout shows: on the ``experts``
    case a data rank's own groups (32 of one token each, where the whole
    batch has 32 of two) give another aux (the mean over the two halves of
    the batch, routed apart) than the whole batch's, and the port's aux is
    the whole batch's; on the ``drop`` case the whole batch's experts drop
    routed slots past their capacity of 8."""
    want = world["modules"]
    aux, halves = float(want["moe_experts.aux"]), \
        float(want["moe_experts.aux_halves"])
    assert abs(aux - halves) > 1e-2, (aux, halves)
    for arrs, _ in world["ranks"]:
        assert abs(float(arrs["moe_experts.aux"]) - aux) <= 1e-5
    assert int(want["moe_drop.dropped"]) > 0
