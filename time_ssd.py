#!/usr/bin/env python3
"""Time the port's SSD chunk kernels and its reduce and scan kernels on one
card, beside other versions.

    python3 time_ssd.py                 # this checkout's kernels
    python3 time_ssd.py --other DIR     # and DIR's (a checkout, e.g. the
                                        # parent commit unpacked by
                                        # git archive), in turns: DIR, this,
                                        # this, DIR
    python3 time_ssd.py --ablate        # and copies of this checkout's
                                        # tensor-core chunk loop
                                        # (csrc/ssd_chunk.cuh) with one
                                        # phase removed each

The reduce and scan cases (``tcu_reduce``, ``tcu_scan`` at 2^24 elements,
from 2^20 rows of 16 to one row of 2^24, and ``matmul_local_scan``) are
timed beside their plain versions (``kernels/ref.py``) and ``torch.sum`` /
``torch.cumsum`` on the same input; the
weighted scan at ``chip_smoke.py``'s cases beside its log-depth op
(``weighted_scan_logdepth``), and the local weighted pass at q = 64 (a
call that takes more than a second is reported, not timed);
``--ablate`` takes only the SSD cases. Each version runs in its own
process, so that its ``repro_torch`` and its kernel build are its own;
every build starts at once, in parallel. Times
are medians with a cold L2, taken as ``chip_smoke.py`` takes them
(``Smoke.time_ms``), after the card's name and power limit as
``nvidia-smi`` gives them. An ablated copy computes wrong values: it is
timed, never checked. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (kernel, dtype, B, L, H, P, G, N): the served shapes, a 64-chunk chain,
# f16, and the f32 FMA instance
CASES = (("scan", "bfloat16", 4, 512, 64, 64, 1, 128),
         ("scan", "bfloat16", 4, 468, 64, 64, 1, 128),
         ("scan", "bfloat16", 1, 4096, 64, 64, 1, 128),
         ("scan", "float16", 4, 512, 64, 64, 1, 128),
         ("scan", "float32", 2, 300, 8, 64, 2, 128),
         ("local", "bfloat16", 4, 512, 64, 64, 1, 128),
         ("local", "bfloat16", 4, 468, 64, 64, 1, 128),
         ("local", "float16", 4, 512, 64, 64, 1, 128),
         ("local", "float32", 2, 300, 8, 64, 2, 128))
ABLATE_CASES = (CASES[0], CASES[2], CASES[5])

# (kernel, dtype, rows, n): every 2^24-element case of chip_smoke.py's
# reduce and scan, and the local scan of the log-depth family
REDUCE_SCAN_CASES = (
    ("reduce", "float16", 1 << 20, 16), ("scan", "float16", 1 << 20, 16),
    ("reduce", "float16", 65536, 256), ("scan", "float16", 65536, 256),
    ("reduce", "float16", 4096, 4096), ("scan", "float16", 4096, 4096),
    ("reduce", "float32", 65536, 256), ("scan", "float32", 65536, 256),
    ("reduce", "float32", 16, 1 << 20), ("scan", "float32", 16, 1 << 20),
    ("reduce", "float32", 1, 1 << 24), ("scan", "float32", 1, 1 << 24),
    ("local_scan", "float16", 65536, 256),
    ("local_scan", "float32", 65536, 256))

# one phase of tc_chunk_loop each: (text, replacement) pairs
ABLATIONS = {
    "no G": [("    tc_masked_g<T>(st + TcStage::kB, st + TcStage::kC, dts, "
              "cum, gh, gl,\n                   warp, lane);\n", "")],
    "no next-chunk load": [("    if (k + 1 < mine) load(k + 1, smem + "
                            "((k + 1) & 1) * TcStage::kBytes);\n", "")],
    "no C H": [("      tc_inter<T>(hs, sc, st + TcStage::kC, yo, lane);\n",
                "")],
    "no intra": [("      tc_intra<T>(ax, gh, gl, yo, lane);\n", "")],
    "no state": [("    tc_state<T>(st + TcStage::kX, st + TcStage::kB, wdt, "
                  "hs, warp, lane);\n", "")],
    "no local-pass stores": [
        ("        if (t < d.q && l < d.L && ch * 4 < d.P)\n",
         "        if (t < 0)\n"),
        ("          if (n < d.N && ch * 4 < d.P)\n",
         "          if (n < 0)\n")],
}


def worker(src: Path, label: str, cases, build_only: bool) -> None:
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import ops as kops

    build.load()
    if build_only:
        return
    smoke = chip_smoke.Smoke(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for kernel, dtype, *shape in cases:
            ins = chip_smoke.ssd_inputs(torch, gen, *shape,
                                        getattr(torch, dtype))
            if kernel == "scan":
                ms = smoke.time_ms(lambda: kops.ssd_scan(*ins,
                                                         return_state=True))
            else:
                ms = smoke.time_ms(lambda: kops.matmul_local_ssd(*ins, 64))
            print(f"{label} | {kernel} {dtype} B={shape[0]} L={shape[1]} "
                  f"H={shape[2]} | {ms:.4f} ms", flush=True)
        if cases is CASES:
            time_weighted(torch, smoke, kops, gen, label)
            time_reduce_scan(torch, smoke, kops, ref, gen, label)


def timed(torch, smoke, fn) -> str:
    """The median time of ``fn``, or "not measured" when one call takes more
    than a second on the host clock (a serial chain over a long row)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    if once > 1.0:
        return f"not measured (> 1 s a call: {once:.2f} s once, host clock)"
    return f"{smoke.time_ms(fn):.4f} ms"


def time_weighted(torch, smoke, kops, gen, label: str) -> None:
    """The weighted scan at each of chip_smoke.py's cases, and its
    log-depth op whole (local pass, tree, glue) on the same input; then the
    local pass alone at q = 64."""
    import chip_smoke

    for dtype, rows, n in chip_smoke.WEIGHTED_CASES:
        dt = getattr(torch, dtype)
        x = torch.randn(rows, n, generator=gen, device="cuda").to(dt)
        la = (-0.5 * torch.rand(rows, n, generator=gen, device="cuda")).to(dt)
        for name, fn in (
                ("weighted_scan", lambda: kops.weighted_scan(x, la)),
                ("weighted_scan_logdepth",
                 lambda: kops.weighted_scan_logdepth(x, la))):
            print(f"{label} | {name} {dtype} {rows} x {n} | "
                  f"{timed(torch, smoke, fn)}", flush=True)
    for rows, n in ((64, 4096), (16, 1 << 20)):
        x = torch.randn(rows, n, generator=gen, device="cuda")
        la = -0.5 * torch.rand(rows, n, generator=gen, device="cuda")
        fn = (lambda: kops.matmul_local_weighted(x, la, 64))
        print(f"{label} | local_weighted float32 {rows} x {n} q=64 | "
              f"{timed(torch, smoke, fn)}", flush=True)


def time_reduce_scan(torch, smoke, kops, ref, gen, label: str) -> None:
    """Each case of REDUCE_SCAN_CASES, its plain version and its library
    call."""
    for kernel, dtype, rows, n in REDUCE_SCAN_CASES:
        x = torch.randn(rows, n, generator=gen, device="cuda").to(
            getattr(torch, dtype))
        if kernel == "reduce":
            fn = (lambda: kops.segmented_reduce(x))
            plain = (lambda: ref.segmented_reduce_ref(x))
            lib = (lambda: torch.sum(x, -1, dtype=torch.float32))
        elif kernel == "scan":
            fn = (lambda: kops.segmented_scan(x))
            plain = (lambda: ref.segmented_scan_ref(x))
            lib = (lambda: torch.cumsum(x, -1, dtype=torch.float32))
        else:
            fn = (lambda: kops.matmul_local_scan(x, 256))
            plain = (lambda: ref.local_scan_ref(x, 256))
            lib = (lambda: torch.cumsum(x.view(rows, -1, 256), -1,
                                        dtype=torch.float32))
        ms, plain_ms, lib_ms = (smoke.time_ms(f) for f in (fn, plain, lib))
        print(f"{label} | {kernel} {dtype} {rows} x {n} | {ms:.4f} ms | "
              f"plain {plain_ms:.4f} ms | library {lib_ms:.4f} ms",
              flush=True)


def ablated_copy(name: str, edits) -> Path:
    dst = ROOT / "build" / "ablate" / name.replace(" ", "_") / "src"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "src" / "repro_torch", dst / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    body = dst / "repro_torch" / "csrc" / "ssd_chunk.cuh"
    text = body.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"time_ssd: the ablation {name!r} no longer "
                             "matches csrc/ssd_chunk.cuh")
        text = text.replace(old, new)
    body.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--worker", nargs=2, metavar=("SRC", "LABEL"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--cases", choices=("all", "ablate"), default="all",
                    help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(Path(args.worker[0]), args.worker[1],
               ABLATE_CASES if args.cases == "ablate" else CASES,
               args.build_only)
        return 0

    import chip_smoke

    print(chip_smoke.smi_line(), flush=True)
    this = ROOT / "src"
    runs = [(this, "this", "all")]
    if args.other is not None:
        other = (args.other / "src").resolve()
        runs = [(other, "other", "all"), (this, "this", "all"),
                (this, "this again", "all"), (other, "other again", "all")]
    if args.ablate:
        runs.append((this, "ablate: none", "ablate"))
        runs += [(ablated_copy(name, edits), f"ablate: {name}", "ablate")
                 for name, edits in ABLATIONS.items()]

    def cmd(src, label, cases, *extra):
        return [sys.executable, str(Path(__file__).resolve()), "--worker",
                str(src), label, "--cases", cases, *extra]

    builds = {src: subprocess.Popen(cmd(src, "build", "all", "--build-only"))
              for src in dict.fromkeys(src for src, _, _ in runs)}
    failed = [str(src) for src, p in builds.items() if p.wait()]
    if failed:
        print(f"time_ssd: the build failed in {failed}", file=sys.stderr)
        return 1
    rc = 0
    for src, label, cases in runs:
        rc |= subprocess.run(cmd(src, label, cases)).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
