"""Serving entry point of the port: greedy generation.

    python -m repro_torch.launch.serve                  # mamba2-1.3b FULL
    python -m repro_torch.launch.serve --arch llama3.2-1b
    python -m repro_torch.launch.serve --scheduler wave \
        --policy ssd=tile_logdepth
    python -m repro_torch.launch.serve --config smoke --device cpu

The continuous scheduler is the default, as in the reference: per-slot
admission, a ring KV cache, chunked prefill (``--prefill-chunk`` prompt
tokens a tick) mixed with decode; on the card every tick replays a CUDA
graph of the block step. ``--scheduler wave`` serves left-padded waves
through one prefill and decode steps.

Randomly initialised weights from a ``torch.Generator`` seeded with
``--seed``; synthetic prompts from a numpy generator with the same seed. By
default the model runs on the CUDA card through the Hopper kernels:
RMSNorm in every layer, and in the wave's prefill also the SSD chunk scan
or flash attention (the continuous block step runs the recurrence and
decode attention as torch ops, as the reference does). ``--device cpu``
runs the same path on each kernel's plain version. Under the wave
scheduler, ``--policy
ssd=tile_logdepth`` prefills every Mamba layer through the log-depth
MatMulScan family instead: the carry-free chunk kernel of
``csrc/matmul_scan.cu`` and a tree of batched matmuls over the chunk
states. A bare ``--policy tile_logdepth`` raises on the model's RMSNorm,
which has no log-depth form.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as devmod
from repro_torch.models import build_lm
from repro_torch.models.common import init_params
from repro_torch.serving import Request, ServeConfig, ServingEngine


def build_engine(arch: str = "mamba2-1.3b", config: str = "full", *,
                 device=None, policy: str | None = None, slots: int = 4,
                 max_new: int = 16, scheduler: str = "continuous",
                 prefill_chunk: int = 16, cache_kind: str = "ring",
                 seed: int = 0) -> ServingEngine:
    """A serving engine over randomly initialised weights."""
    serve_cfg = ServeConfig(slots=slots, max_new=max_new, policy=policy,
                            scheduler=scheduler, prefill_chunk=prefill_chunk,
                            cache_kind=cache_kind)
    mod = configs.get(arch)
    cfg = mod.FULL if config == "full" else mod.SMOKE
    bundle = build_lm(cfg)
    gen = torch.Generator(device=devmod.resolve(device)).manual_seed(seed)
    params = init_params(bundle.params_pspec, gen, cfg.dtype)
    return ServingEngine(bundle, params, serve_cfg)


def make_requests(n: int, prompt_len: int, vocab: int,
                  seed: int = 0) -> list[Request]:
    """``n`` prompts of 4..prompt_len tokens, drawn as the reference's
    ``launch.serve`` draws them."""
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
        3, vocab, size=rng.integers(4, prompt_len + 1), dtype=np.int32))
        for i in range(n)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b",
                    help="mamba2-1.3b or llama3.2-1b")
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
                    help="KV-cache layout of the continuous scheduler "
                         "(only the ring is ported)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default=None,
                    help="path policy: tile (the kernels, default), fused, "
                         "baseline, or op=path overrides; ssd=tile_logdepth "
                         "prefills the SSD through the log-depth family")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight and synthetic-request seed")
    args = ap.parse_args(argv)

    engine = build_engine(args.arch, args.config, device=args.device,
                          policy=args.policy, slots=args.slots,
                          max_new=args.max_new, scheduler=args.scheduler,
                          prefill_chunk=args.prefill_chunk,
                          cache_kind=args.cache, seed=args.seed)
    reqs = make_requests(args.requests, args.prompt_len,
                         engine.bundle.cfg.vocab, args.seed)
    t0 = time.perf_counter()
    results = engine.run(reqs)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in results)
    for r in results[:4]:
        print(f"req {r.uid}: prompt_len={r.prompt_len} -> "
              f"{len(r.tokens)} tokens: {r.tokens[:12]}")
    print(f"{len(results)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / max(dt, 1e-9):.1f} tok/s, "
          f"scheduler={engine.scheduler}, "
          f"device={engine.device})")


if __name__ == "__main__":
    main()
