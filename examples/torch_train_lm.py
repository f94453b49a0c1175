"""End-to-end training on the PyTorch port: a ~100M-parameter llama-family
model on synthetic data, with checkpointing and resume.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300]
      [--device cpu --config smoke]

Config -> data pipeline -> train step (every reduction through the
dispatch ops: the global norm's reduce runs ``tcu_reduce`` on the card) ->
AdamW -> checkpoint. Run it again with a larger ``--steps`` and it resumes
from the last checkpoint in ``--ckpt-dir``. On the card the same loop runs
the FULL configs through ``repro_torch.launch.train``.
"""
import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline
from repro_torch.models import build
from repro_torch.models.layers import ModelConfig
from repro_torch.ops import KernelPolicy
from repro_torch.optim import OptConfig
from repro_torch.training import init_train_state, make_train_step

# ~100M params: 12L, d=768, llama-style
CFG_100M = ModelConfig(
    name="llama-100m", family="dense",
    n_layers=12, d_model=768, vocab=32000,
    n_heads=12, n_kv_heads=4, d_ff=2048, head_dim=64,
    tie_embeddings=True, dtype=torch.float32, remat_policy="off",
)
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "build", "train_lm_ckpt")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--config", choices=("100m", "smoke"), default="100m",
                    help="the ~100M model, or llama3.2-1b's SMOKE config")
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default=None,
                    help="KernelPolicy for the model's core ops: a path "
                         "label, an op=path,op=path override list (dotted "
                         "keys tune kernel geometry, e.g. 'ssd.q=64'), or "
                         "a JSON object of policy fields")
    args = ap.parse_args()

    cfg = CFG_100M if args.config == "100m" else \
        configs.get("llama3.2-1b").SMOKE
    if args.policy is not None:
        cfg = dataclasses.replace(cfg,
                                  policy=KernelPolicy.from_spec(args.policy))
    bundle = build(cfg)
    print(f"model: {bundle.n_params / 1e6:.1f}M params on {args.device}")
    opt_cfg = OptConfig(peak_lr=6e-4, warmup_steps=30,
                        decay_steps=args.steps, policy=cfg.policy)
    gen = torch.Generator(device=args.device).manual_seed(0)
    state = init_train_state(gen, bundle, opt_cfg)
    step_fn = make_train_step(bundle, opt_cfg)

    start = ckpt.latest_step(args.ckpt_dir) or 0
    if start:
        state = ckpt.restore(args.ckpt_dir, start, state)
        print(f"resumed from step {start}")

    data = SyntheticLMPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch),
        device=args.device)

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = data.device_batch(step)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        if step % 20 == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) / (
                time.time() - t0)
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({tok_s / 1e3:.1f}k tok/s)")
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, state)

    ckpt.save(args.ckpt_dir, args.steps, state)
    if not losses:
        print(f"nothing to train: the checkpoint is at step {start}")
        return
    print(f"loss: {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
          f"(synthetic data: memorisation curve)")
    ok = bool(np.all(np.isfinite(losses))) and \
        ckpt.latest_step(args.ckpt_dir) == args.steps
    print(f"train_lm check: {'OK' if ok else 'FAILED'} (losses finite, "
          f"checkpoint at step {ckpt.latest_step(args.ckpt_dir)})")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
