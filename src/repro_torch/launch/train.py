"""Training entry point of the port: checkpoint/restart, straggler
reporting and deterministic resume.

    python -m repro_torch.launch.train --arch llama3.2-1b --config full
    python -m repro_torch.launch.train --config smoke --device cpu --steps 4
    python -m repro_torch.launch.train --arch seamless-m4t-medium \
        --config smoke --device cpu --steps 4
    python -m repro_torch.launch.train --arch mamba2-1.3b --config full \
        --batch 4 --seq 512 --steps 20 --obs-events events.jsonl \
        --metrics-out metrics.prom
    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --device cpu --mesh data=2,model=2

Counterpart of ``repro.launch.train``:

  * periodic checkpointing (step- and wall-clock-triggered) with atomic
    commit (``checkpoint/ckpt.py``), in the reference's layout;
  * ``--resume auto`` restores the latest valid manifest;
  * per-step wall time is logged (host clock, after the step's loss has
    reached the host); steps slower than ``--straggler-factor`` x the
    running median are flagged;
  * data order is a pure function of (seed, step) (``data/pipeline.py``).

Every architecture of ``repro_torch.configs`` trains. By default the model
runs on the CUDA card through the Hopper kernels: RMSNorm in every layer,
flash attention (the dense models, MoE, internvl2; seamless-m4t's encoder
without a causal mask and its decoder's self- and cross-attention) or the
SSD chunk scan (mamba, zamba2's Mamba layers) in every layer, flash
attention in every use of zamba2's shared block and the capacity offsets'
``tcu_scan`` in every MoE layer, each layer's launched again when it is
recomputed in backward (the shared block is not), and the global norm's
``tcu_reduce`` once per parameter leaf. A vlm's batches carry a zero stub
prefix, and an encoder-decoder's zero frames of ``(batch, seq, d_model)``
beside its tokens and labels, as the reference's do.
``--device cpu`` runs the same path on each kernel's plain version. The
learning-rate schedule is the reference's (warmup ``min(20, --steps)``,
cosine to ``--steps``) unless ``--warmup-steps`` or ``--decay-steps`` fix
it, as a run resumed with another ``--steps`` needs to continue the
interrupted one. ``--obs-events``, ``--metrics-out`` and ``--profile-dir``
run under an observability session (``repro_torch.obs.cli``).

Sharded training: under ``torchrun`` / ``python -m torch.distributed.run``
(a world of more than one process, whose environment gives the rank, world
size and rendezvous) the process group is gloo, on the CPU and on the card
alike (every collective goes through host memory,
``core.distributed.host_staged``), and the state is sharded on a
``DeviceMesh``: ``--mesh data=2,model=2`` names it, else ``--tp N`` splits
the world into ``data = world // N`` by ``model = N``
(:func:`build_mesh_context`). Each rank holds its shard of the f32 masters
and moments under ``train_state_pspecs``, trains on its ``data``
coordinate's rows, and writes its shards into the checkpoint; ``--resume
auto`` restores under the *current* mesh's specs, whatever mesh wrote the
checkpoint. Where ``model`` has more than one rank, every model trains
tensor-parallel: a rank computes its share of the heads (the
encoder-decoder's encoder, decoder and cross attention alike), ``ff``
columns, the MoE's experts (or every expert's ``e_ff`` columns where
``model`` does not divide the experts), SSM heads and vocab, and gathers
each layer's weights over ``data`` inside the layer
(``training.train_lib``); on a mesh without a split ``model`` dim every
weight is gathered whole. The MoE routes the groups of the whole batch on
either. Only rank 0 prints. On the card every rank takes ``cuda:<LOCAL_RANK
mod cards>``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.checkpoint import ckpt
from repro_torch.core import dispatch
from repro_torch.core import policy as kpolicy
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.models import build
from repro_torch.obs import cli as obs_cli
from repro_torch.optim import OptConfig
from repro_torch.parallel.mesh_context import MeshContext, init_from_env, \
    make_context
from repro_torch.training import TrainConfig, init_train_state, make_train_step
from repro_torch.training.train_lib import (
    init_sharded_train_state,
    state_shardings,
    train_state_pspecs,
)

# the reference's smoke shape (repro.configs.common: SMOKE_BATCH, SMOKE_SEQ)
SMOKE_BATCH, SMOKE_SEQ = 2, 128
CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def build_mesh_context(tp: int, mesh_arg: str | None = None, *,
                       device: str = "cuda") -> MeshContext:
    """The training MeshContext over the initialised process group: ``--mesh
    data=2,model=2`` wins; otherwise ``--tp``'s split of the world into
    ``data = world // tp`` by ``model = tp``."""
    if mesh_arg:
        return make_context(mesh_arg, device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % tp:
        raise ValueError(f"--tp {tp} does not divide the world of {world}")
    return make_context((("data", world // tp), ("model", tp)),
                        device=device)


def main(argv=None) -> dict[int, float]:
    """Parse ``argv`` and train; returns each step's loss."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=tuple(configs.ARCHS),
                    help="an architecture of repro_torch.configs")
    ap.add_argument("--config", choices=("smoke", "full"), default="smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=SMOKE_BATCH * 2)
    ap.add_argument("--seq", type=int, default=SMOKE_SEQ)
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size of the training mesh: the world "
                         "splits into data = world // tp by model = tp; "
                         "the models then split their heads, ff columns, "
                         "experts (or e_ff), SSM heads and vocab over model "
                         "(tensor parallelism)")
    ap.add_argument("--mesh", default=None,
                    help="mesh axes as 'data=2,model=2' (multiplies to the "
                         "world size); overrides --tp")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int, default=None,
                    help="linear warmup steps (default min(20, --steps))")
    ap.add_argument("--decay-steps", type=int, default=None,
                    help="step the cosine reaches its floor at (default "
                         "--steps)")
    ap.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-every-s", type=float, default=600.0)
    ap.add_argument("--keep-last", type=int, default=3,
                    help="committed checkpoints to keep (0 keeps all)")
    ap.add_argument("--resume", choices=("auto", "none"), default="auto")
    ap.add_argument("--straggler-factor", type=float, default=1.5)
    ap.add_argument("--straggler-report", default=None,
                    help="jsonl path for per-step timing records")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default=None,
                    help="KernelPolicy for the model's core ops and the "
                         "optimizer's global-norm reduce: a path label, an "
                         "op=path,... list or a JSON object of policy "
                         "fields (default: the active policy, auto)")
    ap.add_argument("--tune", default=None,
                    help="per-op kernel tuning overrides layered on the "
                         "policy: op.knob=value pairs, e.g. 'ssd.q=32'")
    ap.add_argument("--kernel-path", default=None, choices=dispatch.PATHS,
                    help="deprecated alias for --policy <path-label>")
    obs_cli.add_obs_args(ap)
    args = ap.parse_args(argv)

    with obs_cli.obs_scope(args) as obs_sess:
        return run(args, obs_sess)


def run(args, obs_sess=None) -> dict[int, float]:
    mod = configs.get(args.arch)
    cfg = mod.SMOKE if args.config == "smoke" else mod.FULL
    pol = kpolicy.policy_from_cli(
        args.policy, getattr(args, "kernel_path", None),
        "deprecated:launch.train.kernel_path",
        tune_arg=getattr(args, "tune", None))
    if pol is not None:
        cfg = dataclasses.replace(cfg, policy=pol)
    bundle = build(cfg)
    device = init_from_env(devmod.resolve(args.device))
    tp, mesh_arg = getattr(args, "tp", 1), getattr(args, "mesh", None)
    mesh_ctx = None
    if mesh_arg or tp > 1 or dist.is_initialized():
        mesh_ctx = build_mesh_context(tp, mesh_arg, device=device.type)
    rank0 = devmod.process()[0] == 0
    opt_cfg = OptConfig(
        peak_lr=args.lr,
        warmup_steps=(min(20, args.steps) if args.warmup_steps is None
                      else args.warmup_steps),
        decay_steps=(args.steps if args.decay_steps is None
                     else args.decay_steps),
        policy=pol)
    train_cfg = TrainConfig(microbatches=args.microbatches)
    ckpt_writer = ckpt.AsyncCheckpointer(
        args.ckpt_dir, keep_last=args.keep_last or None)

    gen = torch.Generator(device=device).manual_seed(0)
    if mesh_ctx is None:
        state = init_train_state(gen, bundle, opt_cfg, train_cfg)
    else:
        state = init_sharded_train_state(gen, bundle, opt_cfg, mesh_ctx,
                                         train_cfg)
        if rank0:
            print(f"training sharded over mesh {mesh_ctx.label()} "
                  f"({dist.get_backend()})")
    step_fn = make_train_step(bundle, opt_cfg, train_cfg, mesh_ctx=mesh_ctx)

    start = 0
    if args.resume == "auto":
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            shardings = None if mesh_ctx is None else state_shardings(
                state, train_state_pspecs(bundle, mesh_ctx.rules, train_cfg),
                mesh_ctx)
            state = ckpt.restore(args.ckpt_dir, latest, state,
                                 shardings=shardings)
            start = latest
            if rank0:
                print(f"resumed from step {latest}")

    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        device=device, sharding=mesh_ctx)
    data.skip_to(start)

    times: list[float] = []
    losses: dict[int, float] = {}
    last_ckpt_t = time.time()
    for step in range(start, args.steps):
        batch = data.device_batch(step)
        rows = batch["tokens"].shape[0]     # this rank's
        if cfg.stub_tokens:
            batch["stub"] = torch.zeros(
                (rows, cfg.stub_tokens, cfg.stub_dim), dtype=cfg.dtype,
                device=device)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (rows, args.seq, cfg.d_model), dtype=cfg.dtype,
                device=device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = metrics["loss"].item()     # waits for the step
        dt = time.perf_counter() - t0
        times.append(dt)
        losses[step] = loss
        if obs_sess is not None:
            obs_sess.histogram(
                "repro_train_step_seconds",
                "optimizer step wall time").observe(dt)
            obs_sess.gauge(
                "repro_train_tokens_per_s",
                "training throughput at the last step").set(
                args.batch * args.seq / max(dt, 1e-9))
            obs_sess.emit("train_step", step=step, seconds=dt, loss=loss)

        med = float(np.median(times[-50:]))
        straggle = len(times) > 5 and dt > args.straggler_factor * med
        if args.straggler_report and rank0:
            with open(args.straggler_report, "a") as f:
                f.write(json.dumps({"step": step, "dt": dt,
                                    "median": med,
                                    "straggler": straggle}) + "\n")
        if straggle and rank0:
            print(f"[straggler] step {step}: {dt:.3f}s vs median "
                  f"{med:.3f}s")
        if rank0 and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {metrics['grad_norm'].item():.3f} "
                  f"lr {metrics['lr'].item():.2e} {dt:.3f}s")

        due_steps = (step + 1) % args.ckpt_every == 0
        due_time = time.time() - last_ckpt_t > args.ckpt_every_s
        if mesh_ctx is not None:
            # every rank saves together (the commit waits for them all):
            # one rank's clock passing the mark is every rank's
            flag = torch.tensor([float(due_time)])
            dist.all_reduce(flag)
            due_time = bool(flag.item() > 0)
        if due_steps or due_time or step == args.steps - 1:
            # async: snapshots now, writes in the background; the next
            # save (or the final wait below) is the commit barrier
            ckpt_writer.save(step + 1, state)
            last_ckpt_t = time.time()
            if rank0:
                print(f"checkpoint scheduled @ step {step + 1}")

    path = ckpt_writer.wait()
    if rank0:
        print(f"checkpointed -> {path}")
        if times:
            print(f"done: {args.steps - start} steps, "
                  f"median step {np.median(times):.3f}s on {device}"
                  + ("" if mesh_ctx is None
                     else f" (mesh {mesh_ctx.label()})"))
    return losses


if __name__ == "__main__":
    main()
