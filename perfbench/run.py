#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 perfbench/run.py --workload mamba2-1.3b.chat --seed 7 \\
        --seconds 30 --trace 0

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``, and last
``checks``: each number the correctness check compared, beside its limit.
The same checks end standard error. Exits non-zero, printing no result,
without enough cards, when JAX or the JAX package was loaded, or when a
file under ``benchmarks/`` was opened.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from perfbench.lib import guard, manifest  # noqa: E402


@dataclasses.dataclass
class Run:
    """One run of one cell, as a runner sees it."""
    name: str
    seed: int
    seconds: float
    trace: bool
    workload: dict
    cell: dict
    config: dict
    mix: dict
    device: torch.device
    t_start: float
    model_cfg: object = None      # the program's ModelConfig (None: FULL)
    fault: object = None          # a test's planted fault, else None
    control: str | None = None    # the control's precision ("fp8"), else None


def make_run(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, **kw) -> Run:
    w = manifest.workload(bench, name)
    return Run(name=name, seed=seed, seconds=seconds, trace=trace,
               workload=w, cell=manifest.cell(name),
               config=manifest.config(w["config"]),
               mix=manifest.traffic(w["traffic"]), device=torch.device(device),
               t_start=t_start, **kw)


def perform(r: Run, bench: dict) -> dict:
    """Run the cell; -> the result line's object."""
    out = manifest.runner(r.cell["kind"]).run(r)
    rec = out["records"]
    if r.trace:
        wanted = manifest.per_layer(bench, r.name)
        values = {m["name"]: manifest.reader(m["name"])(m["name"], rec)
                  for m in wanted}
    else:
        wanted = manifest.end_to_end(bench, r.name)
        values = {m["name"]: out["values"].get(m["name"]) for m in wanted}
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in wanted if values[m["name"]] is not None}
    cuda = r.device.type == "cuda"
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(r.device) if cuda
              else "cpu", "count": int(r.workload["chips"]),
              "memory_peak_bytes": int(out["peak_bytes"])}
    line = {"correct": None, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if r.trace and rec.slice is not None:
        device["busy_s"] = rec.slice.busy_s
        device["window_s"] = rec.slice.window_s
        line["breakdown"] = {"device_ops": rec.slice.top_ops(),
                             "idle_gaps": rec.slice.idle_gaps()}
    checks = out["checks"]
    line["correct"] = bool(out["failed"] == 0 and all(
        v is not None and v <= lim for _, v, lim in checks))
    line["notes"] = out.get("notes", {})
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    reads = guard.ReadGuard(ROOT)
    bench = manifest.benchmark(ROOT)
    chips = int(manifest.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    r = make_run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), "cuda", T_START)
    line = perform(r, bench)
    bad = guard.forbidden_modules()
    if bad or reads.seen:
        print(f"refused: loaded {bad}, opened under benchmarks/ "
              f"{reads.seen[:5]}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
