#!/usr/bin/env python3
"""Read the two ends of a cell's correctness limits on the card.

    python3 perfbench/control.py --workload mamba2-1.3b.chat \\
        --seeds 11 12 13 --seconds 10

For each seed, in one process. A serving cell runs as the benchmark runs
it (a short window at the cell's own load) and gives the program's number,
the widest gap of its served tokens below the reference's best, beside the
control's: the reference with float8 products (one precision below the
served bfloat16) in the program's place, the gap of the token it puts
first at each position of the same served sequences. A training cell
gives the control's three numbers (the reference's three steps with
float8 products, against the float32 reference's) and those of two faults
planted in the reference: half of each batch left out; a state left
unchanged reads 1 on the gradient and change and needs no run. With
``--program`` a training cell also runs the program itself. One JSON line
a seed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench import run as bench_run  # noqa: E402
from perfbench.lib import manifest  # noqa: E402
from perfbench.runners import train  # noqa: E402


def readings(r, bench, program: bool) -> dict:
    if r.cell["kind"] == "serve":
        r.control = "fp8"
        line = bench_run.perform(r, bench)
        return {"program": line["checks"]["max_logit_gap"]["value"],
                "control": line["notes"]["control_gap"],
                "correct": line["correct"]}
    out = {}
    if program:
        line = bench_run.perform(r, bench)
        out["program"] = {k: v["value"] for k, v in line["checks"].items()}
        out["program"]["loss_gap"] = line["notes"]["loss_gap"]
        torch.cuda.empty_cache()
    sound = train.reference_steps(r, r.config, r.cell, keep_first=True)
    for name, kw in (("control", {"quant": "fp8"}),
                     ("half_batch", {"rows": slice(0, r.cell["batch"] // 2)})):
        low = train.reference_steps(r, r.config, r.cell,
                                    first=sound["first"], **kw)
        got = train.compare(low["loss"], low["grad"], low["change"], sound,
                            low["direction"])
        out[name] = {k: got[k] for k in ("loss_gap",) + train.COMPARED}
        del low
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.benchmark(ROOT)
    for seed in args.seeds:
        r = bench_run.make_run(bench, args.workload, seed, args.seconds,
                               False, "cuda", time.perf_counter())
        row = {"seed": seed, **readings(r, bench, args.program)}
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
