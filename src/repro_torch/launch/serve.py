"""Serving entry point of the port: greedy generation.

    python -m repro_torch.launch.serve                  # mamba2-1.3b FULL
    python -m repro_torch.launch.serve --arch llama3.2-1b --cache paged
    python -m repro_torch.launch.serve --arch zamba2-2.7b
    python -m repro_torch.launch.serve --arch h2o-danube-3-4b --config smoke \
        --device cpu
    python -m repro_torch.launch.serve --scheduler wave \
        --policy ssd=tile_logdepth
    python -m repro_torch.launch.serve --config smoke --device cpu
    python -m repro_torch.launch.serve --cache paged \
        --obs-events events.jsonl --metrics-out metrics.prom \
        --profile-dir trace/
    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --arch llama3.2-1b --config smoke \
        --device cpu --mesh data=2,model=2 --ckpt-dir build/train_ckpt

The continuous scheduler is the default, as in the reference: per-slot
admission, a ring KV cache, chunked prefill (``--prefill-chunk`` prompt
tokens a tick) mixed with decode; on the card every tick replays a CUDA
graph of the block step. ``--cache paged`` takes the paged KV pool instead
(``--pool-pages``, ``--page-rows``): prompt prefixes shared page by page,
copy-on-write, admission deferred under pool pressure, and for mamba state
snapshots at prompt boundaries. ``--scheduler wave`` serves left-padded
waves through one prefill and decode steps. ``--arrival-rate`` spreads the
requests as open-loop Poisson arrivals.

Randomly initialised weights from a ``torch.Generator`` seeded with
``--seed``; synthetic prompts from a numpy generator with the same seed. By
default the model runs on the CUDA card through the Hopper kernels:
RMSNorm in every layer, the MoE models' capacity offsets (``tcu_scan.cu``)
in every MoE layer, and in the wave's prefill also the SSD chunk scan or
flash attention (zamba2: the SSD in each of its 54 Mamba layers, flash
attention in each of the shared block's 9 uses; the continuous block step
runs the recurrence and decode attention as torch ops, as the reference
does). The MoE configs, deepseek-67b and internvl2-76b at FULL do not fit
one card; ``chip_smoke.py`` runs them with their depth cut. internvl2-76b is
served text-only by the continuous scheduler (its block step embeds tokens,
as the reference's does); its wave prefill needs the stub prefix, which the
synthetic requests do not carry, and raises. h2o-danube-3-4b's sliding
window is taken on every scheduler; its wave raises where prompt and budget
pass the window. seamless-m4t-medium (the encoder-decoder) has no block
step: the engine warns and falls back to the wave, whose prefill raises for
the missing ``frames``, as the reference's fails on that key. ``--device cpu``
runs the CPU's ``auto`` choice (``--policy tile``: each kernel's plain
version). ``--tune "ssd.q=32"`` sets a kernel knob (see
``repro_torch.core.policy``). Under the wave
scheduler, ``--policy
ssd=tile_logdepth`` prefills every Mamba layer through the log-depth
MatMulScan family instead: the carry-free chunk kernel of
``csrc/matmul_scan.cu`` and a tree of batched matmuls over the chunk
states. A bare ``--policy tile_logdepth`` raises on the model's RMSNorm,
which has no log-depth form.

``--obs-events``, ``--metrics-out`` and ``--profile-dir`` (the reference's
flags, ``repro_torch.obs.cli``) run the serve under an observability
session: a JSON-lines file of every event, the run's metrics as Prometheus
text, and a ``torch.profiler`` Chrome trace. With none of them the run is
uninstrumented.

``--ckpt-dir`` serves the parameters of the latest committed step of a
checkpoint that ``launch.train`` wrote (any mesh, any world size). Under
``torchrun`` with ``--mesh data=a,model=b`` the engine serves sharded in
lockstep (``serving/engine.py``): the parameters are placed under
``partition_specs(..., fsdp_ok=False)`` of the context's rules (a
checkpoint is restored straight into those shards, as the reference's
``launch/serve.py`` places them) and each rank keeps its ``model`` share
of them; each rank steps its ``data`` rows of the slots (``--slots`` must
divide by ``a``) on its heads, ``ff`` columns, the MoE's experts (or
every expert's ``e_ff`` columns where ``b`` does not divide the experts),
SSM heads and vocab, and holds that part of the cache; only rank 0
prints. The MoE routes the groups of the whole slot grid, as the
reference's one program does. The encoder-decoder has no block step, and
the wave scheduler it falls back to raises under lockstep (as the
reference's engine); its sharded wave steps run through
``training.make_serve_step(bundle, mesh_ctx=)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.core import dispatch
from repro_torch.core import policy as kpolicy
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.models import build
from repro_torch.models.common import init_params, partition_specs, \
    stack_pspec
from repro_torch.obs import cli as obs_cli
from repro_torch.parallel import sharded_state
from repro_torch.parallel.mesh_context import init_from_env, make_context
from repro_torch.serving import Request, ServeConfig, ServingEngine


def build_engine(arch: str = "mamba2-1.3b", config: str = "full", *,
                 device=None, policy=None, slots: int = 4,
                 max_new: int = 16, scheduler: str = "continuous",
                 prefill_chunk: int = 16, cache_kind: str = "ring",
                 pool_pages: int | None = None, page_rows: int | None = None,
                 greedy: bool = True, temperature: float = 1.0,
                 seed: int = 0, mesh_ctx=None,
                 ckpt_dir: str | None = None) -> ServingEngine:
    """A serving engine over randomly initialised weights from ``seed``,
    which also seeds its sampling, or the latest committed step of
    ``ckpt_dir``. ``mesh_ctx`` places the parameters under its rules
    (``fsdp_ok=False``) and serves sharded."""
    serve_cfg = ServeConfig(slots=slots, max_new=max_new, policy=policy,
                            scheduler=scheduler, prefill_chunk=prefill_chunk,
                            cache_kind=cache_kind, pool_pages=pool_pages,
                            page_rows=page_rows, greedy=greedy,
                            temperature=temperature, seed=seed)
    mod = configs.get(arch)
    cfg = mod.FULL if config == "full" else mod.SMOKE
    bundle = build(cfg)
    device = devmod.resolve(device)
    latest = ckpt.latest_step(ckpt_dir) if ckpt_dir else None
    if latest is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        params = init_params(bundle.params_pspec, gen, cfg.dtype)
        if mesh_ctx is not None:
            params = sharded_state.place_tree(
                params, _param_shardings(bundle.params_pspec, mesh_ctx))
    else:
        # the train state's stacked leaves, restored into this mesh's shards
        stacked = stack_pspec(bundle.params_pspec)
        target = {"params": tree.map_tree(
            lambda ps: torch.empty(0, device=device), stacked)}
        shardings = None if mesh_ctx is None else {
            "params": _param_shardings(stacked, mesh_ctx)}
        params = ckpt.restore(ckpt_dir, latest, target,
                              shardings=shardings)["params"]
        if devmod.process()[0] == 0:
            print(f"loaded checkpoint step {latest}")
    return ServingEngine(bundle, params, serve_cfg, mesh_ctx=mesh_ctx)


def _param_shardings(pspec, mesh_ctx):
    """Each parameter's ``NamedSharding`` under the context's rules, FSDP
    off (the reference's serving placement)."""
    specs = partition_specs(pspec, rules=mesh_ctx.rules, fsdp_ok=False)
    return tree.map_tree(lambda _, spec: mesh_ctx.named_sharding(spec),
                         pspec, specs)


def make_requests(n: int, prompt_len: int, vocab: int, seed: int = 0,
                  arrival_rate: float = 0.0) -> list[Request]:
    """``n`` prompts of 4..prompt_len tokens, drawn as the reference's
    ``launch.serve`` draws them: with ``arrival_rate`` > 0 (requests a
    second) each request first draws its exponential gap to the last."""
    rng = np.random.default_rng(seed)
    arrival, reqs = 0.0, []
    for i in range(n):
        if arrival_rate > 0:
            arrival += float(rng.exponential(1.0 / arrival_rate))
        reqs.append(Request(uid=i, prompt=rng.integers(
            3, vocab, size=rng.integers(4, prompt_len + 1), dtype=np.int32),
            arrival_s=arrival))
    return reqs


def main(argv=None) -> ServingEngine:
    """Parse ``argv`` and serve; returns the engine, whose ``results`` and
    ``kv_stats()`` hold the run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b",
                    choices=tuple(configs.ARCHS),
                    help="an architecture of repro_torch.configs")
    ap.add_argument("--config", choices=("smoke", "full"), default="full")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--scheduler", choices=("continuous", "wave"),
                    default="continuous",
                    help="continuous batching (per-slot admission, ring "
                         "KV cache, chunked prefill) or the wave baseline")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens a prefilling slot consumes per "
                         "tick (continuous scheduler)")
    ap.add_argument("--cache", choices=("ring", "paged"), default="ring",
                    help="KV-cache layout (continuous scheduler): per-slot "
                         "ring buffers, or the paged block-table pool with "
                         "prompt-prefix sharing and copy-on-write")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="paged cache: total KV pool pages (default "
                         "(slots+1) x pages-per-slot)")
    ap.add_argument("--page-rows", type=int, default=None,
                    help="paged cache: rows per page, a power-of-two "
                         "multiple of 8 (default kernels/layout.py's "
                         "KV_PAGE_ROWS)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in requests/s "
                         "(0: all requests available immediately)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default=None,
                    help="KernelPolicy for every core op of the served "
                         "model: a path label (tile: the kernels, fused, "
                         "baseline, ...), an op=path,... list "
                         "(ssd=tile_logdepth prefills the SSD through the "
                         "log-depth family) or a JSON object of policy "
                         "fields (default: the active policy, auto)")
    ap.add_argument("--tune", default=None,
                    help="per-op kernel tuning overrides layered on the "
                         "policy: op.knob=value pairs, e.g. 'ssd.q=32'")
    ap.add_argument("--kernel-path", default=None, choices=dispatch.PATHS,
                    help="deprecated alias for --policy <path-label>")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight, sampling and synthetic-request seed")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of this checkpoint's latest "
                         "committed step (launch.train's layout)")
    ap.add_argument("--mesh", default=None,
                    help="mesh axes as 'data=2,model=2' or 'model=2' "
                         "(multiplies to the world size, under torchrun): "
                         "serve sharded in lockstep, the slots over data, "
                         "heads, ff, experts (or e_ff), SSM heads and "
                         "vocab over model")
    obs_cli.add_obs_args(ap)
    args = ap.parse_args(argv)

    with obs_cli.obs_scope(args):
        return run(args)


def run(args) -> ServingEngine:
    pol = kpolicy.policy_from_cli(
        args.policy, getattr(args, "kernel_path", None),
        "deprecated:launch.serve.kernel_path",
        tune_arg=getattr(args, "tune", None))
    device = init_from_env(devmod.resolve(args.device))
    mesh_ctx = None
    if getattr(args, "mesh", None):
        mesh_ctx = make_context(args.mesh, device=device.type)
    rank0 = devmod.process()[0] == 0
    if mesh_ctx is not None and rank0:
        print(f"serving sharded over mesh {mesh_ctx.label()}")
    engine = build_engine(args.arch, args.config, device=device,
                          policy=pol, slots=args.slots,
                          max_new=args.max_new, scheduler=args.scheduler,
                          prefill_chunk=args.prefill_chunk,
                          cache_kind=args.cache, pool_pages=args.pool_pages,
                          page_rows=args.page_rows, seed=args.seed,
                          mesh_ctx=mesh_ctx,
                          ckpt_dir=getattr(args, "ckpt_dir", None))
    reqs = make_requests(args.requests, args.prompt_len,
                         engine.bundle.cfg.vocab, args.seed,
                         args.arrival_rate)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    dt = time.perf_counter() - t0
    if not rank0:
        return engine
    n_tok = sum(len(r.tokens) for r in results)
    for r in results[:4]:
        print(f"req {r.uid}: prompt_len={r.prompt_len} -> "
              f"{len(r.tokens)} tokens: {r.tokens[:12]}")
    print(f"{len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, "
          f"scheduler={engine.scheduler}, "
          f"device={engine.device})")
    kv = engine.kv_stats()
    if kv is not None:
        print(f"paged KV pool: peak {kv.get('peak_pages_in_use', 0)}/"
              f"{kv.get('pages_total', 0)} pages, "
              f"{kv['shared_tokens']} prompt tokens prefix-shared, "
              f"{kv['cow_copies']} CoW copies, {kv['defers']} admissions "
              "deferred")
    if args.arrival_rate > 0:
        lats = [1e3 * (ts - r.arrival_s)
                for r in results for ts in r.token_s]
        if lats:
            print(f"open loop @ {args.arrival_rate:.1f} req/s: token "
                  f"latency p50={np.percentile(lats, 50):.1f}ms "
                  f"p99={np.percentile(lats, 99):.1f}ms")
    return engine


if __name__ == "__main__":
    main()
