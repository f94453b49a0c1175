"""BENCHMARK.json against the benchmark's contract, the import guard, and
that a configuration, a traffic mix, a cell and a per-layer metric are
added as files alone."""
import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.lib import guard, manifest

ROOT = manifest.ROOT
PACKAGE = manifest.PACKAGE
BENCH = manifest.benchmark()
PY_FILES = sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py"))
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj", "head",
               "expand", "experts_per_tok", "num_experts_per_tok", "d_ff",
               "d_model", "ffn")


def test_top_level_keys_are_the_contract_s():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]


def test_manifest_has_no_problem():
    assert manifest.problems(BENCH) == []


def test_entries_have_just_the_contract_s_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


def test_every_cell_reporting_a_layer_metric_reports_what_it_moves():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            reported = [e["name"] for e in manifest.end_to_end(BENCH, cell)]
            assert m["moves"] in reported, (m["name"], cell)


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + \
        [w["traffic"] for w in BENCH["workloads"]]
    for n in names:
        assert re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"]), m
    for p in PACKAGE.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = str(p.relative_to(ROOT))
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel


def test_shares_are_percent_and_mfu_is_named():
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    rooflines = {m["moves"] for m in BENCH["per_layer"]
                 if "_roofline" in m["name"]}
    with_mfu = {m["moves"] for m in BENCH["per_layer"] if "mfu" in m["name"]}
    assert rooflines <= with_mfu


def test_bounds_and_run_seconds_fit_the_check():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert [m["bound"] for m in BENCH["end_to_end"]
            if m["name"] == "setup_s"] == [0.25]


def test_config_files_hold_the_sizes_and_reduce_no_width():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg["changed"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS), key
        assert (PACKAGE / "configs" / f"{cfg['reference']}.py").exists()


@pytest.mark.parametrize("path", PY_FILES)
def test_no_file_imports_jax_or_the_jax_package(path):
    tree = ast.parse((ROOT / path).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & set(guard.FORBIDDEN), (path, tops)
    assert "benchmarks" not in tops


def test_references_import_nothing_of_the_program():
    refs = sorted((PACKAGE / "configs").glob("reference_*.py"))
    assert refs
    for path in refs:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] in ("torch", "math", "dataclasses",
                                           "__future__"), (path.name, n)


def test_the_guard_compares_whole_top_level_names():
    names = ["repro_torch.serving.engine", "reprox", "jaxtyping", "torch",
             "perfbench.run"]
    assert guard.forbidden_modules(names) == []
    assert guard.forbidden_modules(names + ["jax.numpy", "repro.ops",
                                            "flax"]) == ["flax", "jax",
                                                         "repro"]


def test_new_entries_need_only_new_files(tmp_path):
    """A configuration, traffic mix, cell and per-layer metric added as new
    files: the harness finds each by its name, and no file that was there
    changes."""
    root = tmp_path / "checkout"
    shutil.copytree(PACKAGE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*")
              if p.is_file()}
    pkg = root / "perfbench"
    (pkg / "configs" / "dummy-0.1b.json").write_text(json.dumps(dict(
        manifest.config("mamba2-1.3b"), name="dummy-0.1b", n_layers=2)))
    (pkg / "traffic" / "dummy.json").write_text(json.dumps(dict(
        manifest.traffic("chat"), lead_in_s=0)))
    (pkg / "cells" / "dummy-0.1b.dummy.json").write_text(json.dumps(dict(
        manifest.cell("mamba2-1.3b.chat"), rate_rps=2.0)))
    (pkg / "layer_metrics" / "dummy_ticks.py").write_text(
        "def read(name, rec):\n    return float(len(rec.ticks))\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="dummy-0.1b",
                                 file="perfbench/configs/dummy-0.1b.json"))
    bench["workloads"].append({"name": "dummy-0.1b.dummy",
                               "config": "dummy-0.1b", "traffic": "dummy",
                               "chips": 1, "why": "a dummy cell"})
    for m in bench["end_to_end"]:
        if m["name"] in ("ttft_p90_ms", "itl_p95_ms"):
            m["workloads"].append("dummy-0.1b.dummy")
    bench["per_layer"].append({
        "name": "dummy_ticks.dummy", "unit": "ticks", "better": "higher",
        "source": "host_clock", "layer": "scheduler: serving/engine.py",
        "moves": "ttft_p90_ms", "workloads": ["dummy-0.1b.dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from perfbench.lib import manifest, records\n"
        "b = manifest.benchmark()\n"
        "assert manifest.problems(b) == [], manifest.problems(b)\n"
        "w = manifest.workload(b, 'dummy-0.1b.dummy')\n"
        "assert manifest.config(w['config'])['n_layers'] == 2\n"
        "assert manifest.traffic(w['traffic'])['lead_in_s'] == 0\n"
        "assert manifest.cell(w['name'])['rate_rps'] == 2.0\n"
        "names = [m['name'] for m in manifest.per_layer(b, w['name'])]\n"
        "assert names == ['dummy_ticks.dummy'], names\n"
        "rec = records.Records(cell={}, config={}, window=(0, 1),\n"
        "                      ticks=[1, 2, 3])\n"
        "assert manifest.reader(names[0])(names[0], rec) == 3.0\n"
        "assert manifest.runner(manifest.cell(w['name'])['kind']).run\n")
    out = subprocess.run([sys.executable, "-c", script, str(root)],
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _cuda_available() -> bool:
    import torch
    return torch.cuda.is_available()


def test_run_refuses_without_a_card(tmp_path):
    if _cuda_available():
        pytest.skip("a card is here: the refusal is for hosts without one")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mamba2-1.3b.chat", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_run_refuses_in_a_directory_of_only_the_benchmark(tmp_path):
    shutil.copytree(PACKAGE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "mamba2-1.3b.train", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=env)
    assert out.returncode != 0 and out.stdout == ""


def test_every_cell_names_files_that_exist():
    for w in BENCH["workloads"]:
        assert (PACKAGE / "cells" / f"{w['name']}.json").exists()
        assert (PACKAGE / "traffic" / f"{w['traffic']}.json").exists()
        cell = manifest.cell(w["name"])
        assert (PACKAGE / "runners" / f"{cell['kind']}.py").exists()
        assert all(math.isfinite(v) and v > 0
                   for v in cell["limits"].values())


def test_the_configuration_is_the_release_s_head_and_rows():
    cfg = manifest.config("mamba2-1.3b")
    m = cfg["pad_vocab_size_multiple"]
    assert cfg["vocab"] == -(-cfg["vocab_size"] // m) * m == 50288
    assert cfg["tie_embeddings"] and cfg["reduced"] == []
    specs = manifest.reference(cfg).param_specs(cfg)
    assert "head" not in specs
    assert specs["embed"].shape == (50288, cfg["d_model"])
