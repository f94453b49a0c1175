"""Sequence-parallel decayed scan on the PyTorch port: the paper's
grid-level scan across ranks.

Run:  PYTHONPATH=src python examples/torch_ssd_long_context.py [--device cpu]

The long_500k story at example scale: the sequence of a Mamba-2 SSD
layer's decayed scan is split over a world of 4 ranks (gloo; on the card
the 4 processes share it, each collective staged through host memory).
Each rank scans its piece in matmul form, and the cross-rank carry is the
paper's scan-then-propagate (``repro_torch.ops.dist_weighted_scan``):
triangular matmuls at tile, core and world level. Rank 0 gathers the
pieces and holds them against the single-device scan.
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def worker(rank: int, init: str, args) -> None:
    from repro_torch.core.distributed import all_gather
    from repro_torch.ops import dist_weighted_scan, weighted_scan

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD)
    try:
        dev = torch.device(args.device)
        gen = torch.Generator(device=dev).manual_seed(0)
        x = torch.randn(2, args.seq, generator=gen, device=dev)
        log_a = -torch.rand(2, args.seq, generator=gen, device=dev) * 0.01
        n = args.seq // WORLD
        piece = slice(rank * n, (rank + 1) * n)
        got = dist_weighted_scan(x[:, piece], log_a[:, piece])
        whole = torch.cat(all_gather(got).unbind(0), dim=-1)
        if rank == 0:
            # single-device reference through the public facade (the
            # fused matmul form)
            want = weighted_scan(x, log_a, policy="fused")
            err = (whole - want).abs().max().item()
            print(f"sequence-parallel decayed scan over {WORLD} ranks, "
                  f"seq={args.seq}, on {dev}")
            print(f"max |seq-parallel - single-device| = {err:.2e}")
            if not err < 1e-2:
                raise SystemExit(f"ssd_long_context check: FAILED ({err})")
            print("ssd_long_context check: OK (the grid-level carry, "
                  "paper Sec 5.3)")
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seq", type=int, default=1 << 16,
                    help="sequence length (a multiple of 4)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.seq % WORLD:
        ap.error(f"--seq must be a multiple of {WORLD}")
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        mp.spawn(worker, args=(init, args), nprocs=WORLD)


if __name__ == "__main__":
    main()
