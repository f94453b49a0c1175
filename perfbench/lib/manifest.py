"""``BENCHMARK.json`` and the files it names.

Each kind of thing is found by its name: a configuration in
``configs/<name>.json`` (its plain reference in ``configs/<reference>.py``),
a traffic mix in ``traffic/<name>.json``, a cell's settings in
``cells/<cell>.json``, a cell's runner in ``runners/<kind>.py``, and the
reader of a per-layer metric in ``layer_metrics/<base>.py``, ``<base>``
being the metric's name up to its first dot (``tick_ms.t16.chat`` is read
by ``tick_ms.py``). Adding one of them is adding files.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import re
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = PACKAGE.parent                                   # the checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(PACKAGE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return _json(PACKAGE / "traffic" / f"{name}.json")


def cell(name: str) -> dict:
    return _json(PACKAGE / "cells" / f"{name}.json")


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics the cell reports (with ``--trace 0``)."""
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics the cell reports (with ``--trace 1``)."""
    return [m for m in bench["per_layer"] if _applies(m, cell_name)]


def load(path: Path, modname: str):
    """The module of a file that is not on the import path, loaded once."""
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """The ``read(name, records) -> float | None`` of a per-layer metric."""
    base = metric_name.split(".", 1)[0]
    return load(PACKAGE / "layer_metrics" / f"{base}.py",
                 f"perfbench_layer_{base}").read


def reference(cfg: dict):
    """The plain reference module of a configuration."""
    return load(PACKAGE / "configs" / f"{cfg['reference']}.py",
                 f"perfbench_ref_{cfg['reference']}")


def runner(kind: str):
    return importlib.import_module(f"perfbench.runners.{kind}")


def problems(bench: dict) -> list[str]:
    """What in ``bench`` breaks the benchmark's contract, or misses a file
    the harness would look for (empty when sound)."""
    out = []
    cells = {w["name"]: w for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = [c["name"] for c in bench["configs"]] + list(cells) \
        + list(e2e) + [m["name"] for m in bench["per_layer"]]
    if len(set(names)) != len(names):
        out.append("a name is used twice")
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for c in bench["configs"]:
        if not (PACKAGE / "configs" / f"{c['name']}.json").exists():
            out.append(f"no file for config {c['name']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"bad reduced key {key!r}")
    for w in cells.values():
        for what, path in (("traffic", PACKAGE / "traffic"
                            / f"{w['traffic']}.json"),
                           ("cell", PACKAGE / "cells" / f"{w['name']}.json")):
            if not path.exists():
                out.append(f"{w['name']}: no {what} file {path.name}")
        if w["chips"] not in (1, 4):
            out.append(f"{w['name']}: chips must be 1 or 4")
        reported = [m["name"] for m in end_to_end(bench, w["name"])]
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"{w['name']}: needs setup_s and another end-to-end "
                       "metric")
        if not per_layer(bench, w["name"]):
            out.append(f"{w['name']}: no per-layer metric")
    for m in list(e2e.values()) + bench["per_layer"]:
        if not UNIT.match(m["unit"]) or m["better"] not in ("lower",
                                                            "higher"):
            out.append(f"{m['name']}: bad unit or better")
        for c in m.get("workloads", ()):
            if c not in cells:
                out.append(f"{m['name']}: unknown workload {c}")
    for m in e2e.values():
        if m["source"] not in SOURCES_E2E:
            out.append(f"{m['name']}: end-to-end source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in bench["per_layer"]:
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']}")
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
            continue
        base = m["name"].split(".", 1)[0]
        if not (PACKAGE / "layer_metrics" / f"{base}.py").exists():
            out.append(f"{m['name']}: no reader {base}.py")
        for c in m.get("workloads", list(cells)):
            if m["moves"] not in [x["name"] for x in end_to_end(bench, c)]:
                out.append(f"{m['name']}: {c} does not report "
                           f"{m['moves']}")
    return out
