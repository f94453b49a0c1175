"""Batched serving on the PyTorch port: continuous batching over the
engine's slot grid (or the wave baseline via --scheduler wave).

Run:  PYTHONPATH=src python examples/torch_serve_batch.py [--arch mamba2-1.3b]
      [--device cpu]

Serves a reduced-config model (``SMOKE``) with batched requests: chunked
prefill interleaved with decode ticks over a ring KV cache with per-slot
positions; a finished slot is refilled from the queue on the next tick.
Works for every architecture family (dense KV cache, MoE, SSM state cache,
hybrid; the encoder-decoder falls back to the wave scheduler).
--arrival-rate turns the request list into open-loop Poisson arrivals.
"""
import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.models import build
from repro_torch.serving.engine import Request, demo_engine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.all_arch_ids())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--scheduler", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrivals in requests/s "
                         "(0: closed loop)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", default=None,
                    help="KernelPolicy for every core op in the served "
                         "model: a path label, an op=path override list "
                         "(dotted keys tune kernel geometry), or JSON")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    mod = configs.get(args.arch)
    bundle = build(mod.SMOKE)
    engine = demo_engine(bundle, slots=args.slots, max_new=args.max_new,
                         seed=args.seed, scheduler=args.scheduler,
                         prefill_chunk=args.prefill_chunk,
                         policy=args.policy, device=args.device)

    rng = np.random.default_rng(args.seed)
    arrival = 0.0
    reqs = []
    for i in range(args.requests):
        if args.arrival_rate > 0:
            arrival += float(rng.exponential(1.0 / args.arrival_rate))
        reqs.append(Request(uid=i, prompt=rng.integers(
            3, mod.SMOKE.vocab, size=int(rng.integers(8, 24)),
            dtype=np.int32), arrival_s=arrival))

    t0 = time.time()
    results = engine.run(reqs)
    dt = time.time() - t0
    total = sum(len(r.tokens) for r in results)
    for r in results:
        print(f"req {r.uid}: prompt={r.prompt_len} tokens "
              f"-> {r.tokens[:10]}{'...' if len(r.tokens) > 10 else ''}")
    print(f"\n{len(results)} requests, {total} new tokens, {dt:.2f}s "
          f"({total / max(dt, 1e-9):.1f} tok/s on {args.device}, "
          f"scheduler={engine.scheduler})")
    ok = (sorted(r.uid for r in results) == list(range(args.requests))
          and total > 0    # a request may stop early at the EOS token
          and all(len(r.tokens) <= args.max_new for r in results)
          and all(0 <= t < mod.SMOKE.vocab for r in results
                  for t in r.tokens))
    print(f"serve_batch check: {'OK' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
