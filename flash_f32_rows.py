#!/usr/bin/env python3
"""Row error and time of the f32 flash-attention instance on one card, beside
another checkout's.

    python3 flash_f32_rows.py               # this checkout's kernel
    python3 flash_f32_rows.py --other DIR   # and DIR's (a checkout, e.g. the
                                            # parent commit unpacked by
                                            # git archive)

Each case's q, k, v are made once, from seed 0, and go through every
checkout's ``kernels.ops.attention``. The error is ``chip_smoke.py``'s
``row_rel_err``: the largest error in an output row over that row's RMS in
the plain version (``attention_plain``, f32 math) on the same inputs. Rows
of thousands of keys are where a running sum's rounding shows. Times are
the mean of five calls on the host clock, after a first call that builds
the kernels. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (B, Lq, Lk, Hq, Hkv, D, causal, window)
CASES = (
    (4, 468, 468, 32, 8, 120, True, None),      # h2o-danube's wave
    (1, 6144, 6144, 32, 8, 120, True, 4096),    # ... its long prompt
    (1, 4096, 4096, 32, 8, 64, True, None),
    (1, 100, 1000, 4, 2, 64, True, None),
    (1, 2048, 2048, 4, 1, 120, True, 256),
    (2, 100, 160, 4, 4, 64, False, None),
)


def row_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    rms = want.pow(2).mean(-1).sqrt().clamp_min(1e-30)
    return ((got - want).abs().amax(-1) / rms).max().item()


def load_ops(root: Path):
    """``repro_torch.kernels.ops`` of the checkout at ``root``; each
    checkout loads its own build of the kernels."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    try:
        return importlib.import_module("repro_torch.kernels.ops")
    finally:
        sys.path.pop(0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="another checkout, timed and checked beside this")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0], flush=True)
    trees = {"this": load_ops(ROOT)}
    if args.other is not None:
        trees = {"other": load_ops(args.other.resolve()), **trees}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (b, lq, lk, hq, hkv, d, causal, window) in CASES:
        def rn(*shape):
            return torch.randn(*shape, generator=gen, device="cuda")

        q, k, v = rn(b, lq, hq, d), rn(b, lk, hkv, d), rn(b, lk, hkv, d)
        kw = dict(causal=causal, window=window)
        want = trees["this"].attention_plain(q, k, v, **kw)
        line = [f"f32 B={b} Lq={lq} Lk={lk} Hq={hq} Hkv={hkv} D={d} "
                f"causal={causal} window={window}"]
        for name, kops in trees.items():
            got = kops.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                kops.attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 5
            line.append(f"{name}: row error {row_rel_err(got, want):.3e}, "
                        f"{ms:.3f} ms")
        print(" | ".join(line), flush=True)
        del q, k, v, want, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
