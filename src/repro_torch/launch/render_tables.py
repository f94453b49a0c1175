"""Render PERF.md's dry-run and roofline tables from the dry-run records,
replacing the <!-- DRYRUN_TABLE --> and <!-- ROOFLINE_TABLE --> markers
(or the BEGIN/END regions a previous render left) in place.

Counterpart of ``repro.launch.render_tables``, whose target is the
reference's EXPERIMENTS.md.

  PYTHONPATH=src python -m repro_torch.launch.render_tables
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
from collections import defaultdict

from repro_torch import configs
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.roofline import (
    default_artifacts,
    lever,
    roofline_frac,
    status,
)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                    ".."))


def _load(art: str, mesh: str) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(art, mesh, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        out[(r["arch"], r["shape"])] = r
    return out


def _gib(rec) -> str:
    return f"{rec['memory']['peak_bytes'] / 2**30:.2f}" if rec else "—"


def _fits(rec) -> str:
    return "—" if not rec else ("yes" if rec["fits"] else "no")


def dryrun_table(art: str) -> str:
    single, multi = _load(art, "single"), _load(art, "multi")
    hbm = mesh_lib.HBM_BYTES / 1e9
    lines = [
        f"| arch | shape | peak GiB/rank (256) | peak GiB/rank (512) | "
        f"fits {hbm:.0f} GB (256/512) | trace s (256) | op flops/rank | "
        "collective B/rank |",
        "|---|---|---|---|---|---|---|---|",
    ]
    unsupported = defaultdict(list)
    for key in sorted(single):
        s, m = single[key], multi.get(key)
        if s["status"] == "unsupported":
            # one line a message, the arch and its family named generically
            reason = re.sub(r"of \S+ \(\w+\) is", "of {arch} ({family}) is",
                            s["reason"])
            unsupported[reason].append(f"{key[0]} {key[1]}")
            continue
        if s["status"] != "ok":
            continue
        m = m if m and m["status"] == "ok" else None
        h = s["op_analysis"]
        lines.append(
            f"| {key[0]} | {key[1]} | {_gib(s)} | {_gib(m)} | "
            f"{_fits(s)} / {_fits(m)} | {s['trace_s']:.0f} | "
            f"{h['flops']:.3g} | {h['collective_total']:.3g} |")
    n_ok = sum(r["status"] == "ok" for r in single.values())
    same = all(multi.get(k, {}).get("status") == r["status"]
               for k, r in single.items())
    skips = [f"{arch} {shape}" for arch in configs.all_arch_ids()
             for shape in configs.get(arch).SKIPS]
    lines += ["", f"{n_ok} cells ok, "
              f"{sum(len(v) for v in unsupported.values())} unsupported and "
              f"{len(skips)} skipped on the 256-rank mesh; the 512-rank mesh "
              f"gives {'the same statuses' if same else 'other statuses'}. "
              "Unsupported, by the port's message, and skipped:", ""]
    for reason, cells in sorted(unsupported.items(), key=lambda kv: kv[1]):
        lines.append(f"- {', '.join(cells)}: {reason}")
    lines.append(f"- {', '.join(skips)}: the configs' SKIPS (full attention "
                 "at 500k positions)")
    return "\n".join(lines)


def roofline_table(art: str) -> str:
    single = _load(art, "single")
    lines = [
        "| arch | shape | status | compute_s | memory_s | collective_s | "
        "dominant | MODEL/op flops | roofline frac | lever on dominant |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    worst, doms = [], defaultdict(int)
    for key in sorted(single):
        r = single[key]
        if r["status"] != "ok":
            continue
        t = r["roofline"]
        frac = roofline_frac(r)
        doms[t["dominant"]] += 1
        worst.append((frac, key))
        lines.append(
            f"| {key[0]} | {key[1]} | {status(r)} | "
            f"{t['compute_s']:.3g} | {t['memory_s']:.3g} | "
            f"{t['collective_s']:.3g} | {t['dominant'].replace('_s', '')} | "
            f"{r['useful_flops_ratio']:.3f} | {frac:.4f} | "
            f"{lever(r)} |")
    worst.sort()
    lines += ["", "Dominant-term histogram: " + ", ".join(
        f"{k.replace('_s', '')}: {v}" for k, v in sorted(doms.items()))
        + ". Worst roofline fractions: " + "; ".join(
            f"{a} × {s} ({f:.4f})" for f, (a, s) in worst[:4]) + "."]
    return "\n".join(lines)


def _splice(text: str, tag: str, body: str) -> str:
    """Replace <!-- TAG --> or an existing BEGIN/END TAG region."""
    begin, end = f"<!-- BEGIN {tag} -->", f"<!-- END {tag} -->"
    wrapped = f"{begin}\n{body}\n{end}"
    if begin in text:
        return re.sub(re.escape(begin) + r".*?" + re.escape(end),
                      lambda _: wrapped, text, flags=re.S)
    return text.replace(f"<!-- {tag} -->", wrapped)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default=default_artifacts())
    ap.add_argument("--target", default=os.path.join(ROOT, "PERF.md"))
    args = ap.parse_args()
    with open(args.target) as f:
        text = f.read()
    text = _splice(text, "DRYRUN_TABLE", dryrun_table(args.artifacts))
    text = _splice(text, "ROOFLINE_TABLE", roofline_table(args.artifacts))
    with open(args.target, "w") as f:
        f.write(text)
    print(f"{os.path.basename(args.target)} tables rendered "
          f"({len(_load(args.artifacts, 'single'))} single-mesh cells).")


if __name__ == "__main__":
    main()
