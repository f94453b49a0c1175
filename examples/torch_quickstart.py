"""Quickstart for the PyTorch port: the paper's primitives through the
``repro_torch.ops`` facade. Every op takes ``policy=`` (which formulation
runs), and a policy can carry ``op_tuning`` (how the kernel runs).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card (the default) ``policy="tile"`` runs the Hopper kernels; on
the CPU the same calls run the kernels' plain versions.
"""
import argparse

import torch

import repro_torch.ops as ops
from repro_torch.ops import KernelPolicy, using_policy


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="elements of the one-row reduce")
    args = ap.parse_args()
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel = "tile" if dev.type == "cuda" else "interpret"

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # ---- 1. the paper's reduction: P @ A tile algebra --------------------
    x = randn(1, args.n)
    total_tile = ops.reduce(x, policy="xla_tile")          # paper-faithful
    total_fused = ops.reduce(x, policy="fused")            # beyond-paper
    want = x.double().sum().item()
    print(f"reduce: tile={total_tile.item():.3f} "
          f"fused={total_fused.item():.3f} float64={want:.3f}")

    # ---- 2. the paper's scan: A U + (L A) 1 ------------------------------
    v = randn(1, 100_000)
    s = ops.scan(v, policy="fused")
    scan_err = (s - torch.cumsum(v.double(), -1)).abs().max().item()
    print(f"scan: max|err| vs float64 cumsum = {scan_err:.2e}")

    # ---- 3. segmented forms (many small segments) ------------------------
    segs = randn(4096, 16)
    print(f"segmented reduce of 4096 x 16: {tuple(ops.reduce(segs).shape)} "
          "(policy=None -> the active policy's auto choice)")

    # ---- 4. the weighted generalisation = Mamba-2's SSD ------------------
    la = -torch.rand(1, 1000, generator=gen, device=dev)
    w = ops.weighted_scan(v[:, :1000], la)
    print(f"weighted scan (y_i = a_i y_(i-1) + x_i): {tuple(w.shape)}")

    # ---- 5. the Hopper kernels (their plain versions on the CPU) ---------
    xt = randn(8, 1000).to(torch.bfloat16)
    k_out = ops.reduce(xt, policy=kernel)
    kernel_ok = torch.allclose(k_out, xt.float().sum(-1), atol=1.0)
    print(f"{kernel} reduce vs torch.sum: {kernel_ok}")

    # ---- 6. a model layer consuming the primitive ------------------------
    h = randn(4, 512).to(torch.bfloat16)
    w_norm = torch.ones(512, device=dev, dtype=torch.bfloat16)
    print(f"rmsnorm (the paper's batch-norm variance, future work): "
          f"{tuple(ops.rmsnorm(h, w_norm).shape)}")

    # ---- 7. tuning is policy too: override the kernel geometry -----------
    tuned = KernelPolicy(path=kernel, op_tuning={"scan": {"block_n": 256}})
    with using_policy(tuned):
        s2 = ops.scan(torch.ones(8, 1000, device=dev))
    print(f"tuned scan (block_n 256): last prefix = {s2[0, -1].item():.0f} "
          "(want 1000)")

    # f32 sums over 2^20 terms: within 1e-6 of the sum of magnitudes
    tol = 1e-6 * x.abs().sum().item()
    ok = (abs(total_fused.item() - want) <= tol
          and abs(total_tile.item() - want) <= tol and scan_err < 1e-2
          and kernel_ok and s2[0, -1].item() == 1000.0)
    print(f"quickstart check: {'OK' if ok else 'FAILED'}")
    if not ok:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
