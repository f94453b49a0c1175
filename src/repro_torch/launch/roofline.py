"""Roofline report: the dry-run records as a table of per-rank terms.

Counterpart of ``repro.launch.roofline``. Reads
``artifacts/dryrun_torch/<mesh>/*.json`` and prints, per (arch x shape):

  compute_s    = op FLOPs / the H100's bf16 peak     (a rank's)
  memory_s     = op HBM bytes / the H100's HBM rate
  collective_s = collective bytes / the link rate between nodes
  dominant term, MODEL/op FLOPs ratio, the roofline fraction (the model's
  FLOPs at peak over the bound) and a one-line lever; a status column
  gives ``ok`` (and whether the peak fits the card) or ``unsupported``.

The constants are ``repro_torch.launch.mesh``'s. :func:`bound` is the same
roofline for one kernel call (``chip_smoke.py``'s kernel table).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import mesh as mesh_lib

# the next lever on each dominant term of a step split over model by
# tensor parallelism (every family's train and serve steps)
LEVERS = {
    "compute_s": "fewer recomputed matmuls (remat 'dots'); the model dim "
                 "inside an NVLink node",
    "memory_s": "fold the f32 casts and elementwise glue into the Hopper "
                "kernels",
    "collective_s": "sequence-parallel activations (a reduce-scatter and an "
                    "all-gather for each all-reduce); the model dim inside "
                    "an NVLink node",
}


def lever(rec: dict) -> str:
    """The next lever on a record's dominant term."""
    return LEVERS[rec["roofline"]["dominant"]]


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card takes to
    move ``nbytes`` through HBM or do ``ops`` operations of ``dtype``'s
    peak rate, whichever is longer."""
    t_bytes = nbytes / mesh_lib.HBM_BW * 1e3
    t_ops = ops / mesh_lib.PEAK_OPS[str(dtype).split(".")[-1]] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def default_artifacts() -> str:
    return os.path.abspath(os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "artifacts",
        "dryrun_torch"))


def load_records(art_dir: str, mesh: str = "single") -> list[dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(art_dir, mesh, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def roofline_frac(rec: dict) -> float:
    """The model's FLOPs a rank at the card's peak over the bound."""
    mf_s = rec["model_flops_per_chip"] / mesh_lib.PEAK_FLOPS_BF16
    return mf_s / max(rec["roofline"]["bound_s"], 1e-30)


def status(rec: dict) -> str:
    if rec["status"] == "ok":
        return "ok, fits" if rec["fits"] else "ok, does not fit"
    return rec["status"]


def fmt_row(rec: dict) -> str:
    if rec["status"] != "ok":
        return (f"| {rec['arch']} | {rec['shape']} | {status(rec)} | — | — "
                f"| — | — | — | — |")
    r = rec["roofline"]
    return (f"| {rec['arch']} | {rec['shape']} | {status(rec)} | "
            f"{r['compute_s']:.3e} | {r['memory_s']:.3e} | "
            f"{r['collective_s']:.3e} | {r['dominant'].replace('_s', '')} | "
            f"{rec['useful_flops_ratio']:.3f} | {roofline_frac(rec):.4f} |")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=default_artifacts())
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()

    recs = [r for r in load_records(args.artifacts, args.mesh)
            if r.get("status") != "skip"]
    print("| arch | shape | status | compute_s | memory_s | collective_s | "
          "dominant | MODEL/op flops | roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|")
    for rec in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        print(fmt_row(rec))
    print()
    ok = [r for r in recs if r["status"] == "ok"]
    doms: dict[str, int] = {}
    for rec in ok:
        doms[rec["roofline"]["dominant"]] = doms.get(
            rec["roofline"]["dominant"], 0) + 1
    print(f"dominant-term histogram: {doms}")
    if ok:
        print("worst roofline fractions:")
        for rec in sorted(ok, key=roofline_frac)[:5]:
            r = rec["roofline"]
            print(f"  {rec['arch']:24s} {rec['shape']:12s} "
                  f"frac={roofline_frac(rec):.4f} dom={r['dominant']} "
                  f"lever: {lever(rec)}")


if __name__ == "__main__":
    main()
