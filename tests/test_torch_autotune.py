"""The port's autotune (``repro_torch.core.autotune``) against the JAX
package's ``repro.core.autotune`` on the CPU.

With both packages pointed at one and the same table file
(``autotune_table=``), the resolved label, the raised error and the
category of the resolution event's ``table_src`` are equal for every bucket
of the table's ops x {f32, bf16} x bands 0-20 and for attention, the SSD and
RMSNorm, at both levels, under the default, ``autotune="off"``, every
explicit label, every global label, per-op overrides, ``backend="cpu"`` and
``interpret_fallback="error"``. ``tuning`` is not compared on the CPU: the
reference's is TPU geometry, and no plain version takes a knob. Also: the
table's bucketing, v1/v2 up-conversion, the section merge and the per-host
merge against the reference's, a malformed explicit table failing while an
unusable implicit default degrades, a ``gpu`` section that leaves CPU
resolution alone, ``measure_table`` emitting the reference's bucket keys,
and the checked-in table and the CLI's ``--check`` and ``--write``.
"""
from __future__ import annotations

import contextlib
import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import autotune as jautotune
from repro.core import policy as jpolicy
from repro_torch import obs as tobs
from repro_torch.core import autotune as tautotune
from repro_torch.core import policy as tpolicy

CPU = torch.device("cpu")
TABLE_OPS = ("reduce", "scan", "weighted_scan", "ragged_reduce",
             "ragged_scan")
MODEL_OPS = ("attention", "ssd", "rmsnorm")
KERNEL_NAME = {"reduce": "segmented_reduce", "scan": "segmented_scan",
               "ssd": "ssd_scan"}
DTYPES = (("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16))
PATHS = ("fused", "xla_tile", "tile", "interpret", "baseline",
         "tile_logdepth", "tile_gpu", "tile_tpu")


@pytest.fixture(autouse=True)
def _fresh_cache():
    jautotune.invalidate_cache()
    tautotune.invalidate_cache()
    yield
    jautotune.invalidate_cache()
    tautotune.invalidate_cache()


def synthetic_table(path, seed: int = 0, backend: str = "cpu") -> dict:
    """A v3 table over the harness's ops at bands 0-20 (some left out, so
    that the heuristic answers there) whose winners are drawn from every
    table label, with timings, the way a measured table records them."""
    rng = np.random.default_rng(seed)
    entries = {}
    for op in TABLE_OPS:
        for tag in ("f32", "bf16"):
            for b in range(21):
                if rng.random() < 0.2:
                    continue
                us = {p: round(float(rng.uniform(1, 100)), 2)
                      for p in rng.choice(PATHS[:6], 3, replace=False)}
                win = str(rng.choice(PATHS)) if rng.random() < 0.3 \
                    else min(us, key=us.get)
                entries[f"{op}/{tag}/{b}"] = {"path": win, "us": us}
    table = {"version": 3, "backends": {backend: {
        "torch": torch.__version__, "entries": entries}}}
    with open(path, "w") as f:
        json.dump(table, f)
    return table


def src_kind(src: str) -> str:
    return src if src in ("none", "static", "heuristic") else "table"


def outcome(pol, sess, **kw):
    """(label, table_src category) of one resolution, or the error type."""
    try:
        got = pol.resolve(**kw)
    except (RuntimeError, ValueError) as e:
        return type(e).__name__
    (ev,) = sess.events.events("resolution")
    assert ev["chosen_path"] == str(got)
    return str(got), src_kind(ev["table_src"])


def calls():
    """Every (op, level, n, dtype) of the comparison."""
    for op in TABLE_OPS + MODEL_OPS:
        for level in ("dispatch", "kernel"):
            if op == "rmsnorm" and level == "dispatch":
                continue
            name = KERNEL_NAME.get(op, op) if level == "kernel" else op
            for b in range(21):
                for _, jd, td in DTYPES:
                    yield name, level, 1 << b, jd, td


POLICIES = (
    ("default", {}),
    ("off", {"autotune": "off"}),
    ("overrides", {"op_paths": {"reduce": "baseline", "scan": "tile",
                                "ssd": "tile_logdepth", "attention": "fused",
                                "rmsnorm": "tile",
                                "weighted_scan": "xla_tile"}}),
    ("backend cpu", {"path": "tile", "backend": "cpu"}),
    ("error", {"interpret_fallback": "error"}),
    ("tile error", {"path": "tile", "interpret_fallback": "error"}),
) + tuple((f"path {p}", {"path": p}) for p in PATHS)


def compare(table: str, fields: dict, explicit=None) -> int:
    jpol = jpolicy.KernelPolicy(autotune_table=table, **fields)
    tpol = tpolicy.KernelPolicy(autotune_table=table, **fields)
    n_cases = 0
    with warnings.catch_warnings(), contextlib.ExitStack() as stack:
        warnings.simplefilter("ignore")
        jsess = stack.enter_context(jobs.using_obs(ring=1))
        tsess = stack.enter_context(tobs.using_obs(ring=1))
        for op, level, n, jd, td in calls():
            if explicit is not None and level == "kernel" and \
                    explicit not in tpolicy.KERNEL_PATHS:
                continue
            want = outcome(jpol, jsess, op=op, n=n, dtype=jd, level=level,
                           explicit=explicit)
            got = outcome(tpol, tsess, op=op, n=n, dtype=td, level=level,
                          explicit=explicit, device=CPU)
            assert got == want, (op, level, n, jd, fields, explicit)
            n_cases += 1
    return n_cases


@pytest.mark.parametrize("which", ["checked-in", "synthetic"])
@pytest.mark.parametrize("name,fields", POLICIES, ids=[p[0] for p in POLICIES])
def test_resolution_matches_the_reference_under_one_table(which, name,
                                                          fields, tmp_path):
    table = str(tautotune.DEFAULT_TABLE_PATH)
    if which == "synthetic":
        table = str(tmp_path / "t.json")
        synthetic_table(table, seed=len(name))
    assert compare(table, fields) > 500


@pytest.mark.parametrize("explicit", PATHS + ("auto",))
def test_explicit_labels_match_the_reference(explicit, tmp_path):
    table = str(tmp_path / "t.json")
    synthetic_table(table, seed=3)
    assert compare(table, {}, explicit=explicit) > 0


def test_bucketing_matches_the_reference():
    for op in TABLE_OPS + MODEL_OPS + tuple(KERNEL_NAME.values()):
        for n in (0, 1, 15, 16, 512, 513, 1 << 20, 1 << 40):
            for _, jd, td in DTYPES:
                assert tautotune.bucket_key(op, n, td) == \
                    jautotune.bucket_key(op, n, jd)
    for tag in ("f32", "bf16", "f16", "f64"):
        assert tautotune.dtype_tag(tautotune.dtype_from_tag(tag)) == tag
    assert tautotune.DEFAULT_BANDS == jautotune.DEFAULT_BANDS
    assert tautotune.OP_CONTENDERS == jautotune.OP_CONTENDERS
    assert (tautotune.HEURISTIC_CROSSOVER, tautotune.CROSSOVER_OPS,
            tautotune.FUSED_DEFAULT_OPS) == (
        jautotune.HEURISTIC_CROSSOVER, jautotune.CROSSOVER_OPS,
        jautotune.FUSED_DEFAULT_OPS)


def test_heuristic_on_a_cpu_tensor_is_the_reference_s():
    for op in TABLE_OPS + MODEL_OPS:
        for n in (1, 16, 512, 513, 1 << 16):
            assert tautotune.heuristic(op, n, device=CPU) == \
                jautotune.heuristic(op, n)
            cands = ("tile", "interpret")
            assert tautotune.heuristic(op, n, candidates=cands,
                                       device=CPU) == \
                jautotune.heuristic(op, n, candidates=cands)


def strip_framework(table: dict) -> dict:
    return {bk: sec["entries"] for bk, sec in table["backends"].items()}


def test_v1_and_v2_tables_up_convert_as_in_the_reference(tmp_path):
    ent = {"reduce/f32/4": {"path": "baseline", "us": {"baseline": 1.0}}}
    v1 = tmp_path / "v1.json"
    v1.write_text(json.dumps({"version": 1, "backend": "cuda",
                              "jax": "0.4", "entries": ent}))
    v2 = tmp_path / "v2.json"
    v2.write_text(json.dumps({"version": 2, "backends": {
        "cpu": {"jax": "0.4", "entries": ent}}}))
    for p in (v1, v2):
        got, want = tautotune.load_table(p), jautotune.load_table(p)
        assert got["version"] == want["version"] == 3
        assert strip_framework(got) == strip_framework(want)
    assert set(strip_framework(tautotune.load_table(v1))) == {"gpu"}


def test_merges_match_the_reference(tmp_path):
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    synthetic_table(a, seed=1)
    synthetic_table(b, seed=2)
    ta, tb = tautotune.load_table(a), tautotune.load_table(b)
    gpu = {"version": 3, "backends": {"gpu": ta["backends"]["cpu"]}}
    merged = tautotune.merge_tables(ta, gpu)
    assert strip_framework(merged) == strip_framework(
        jautotune.merge_tables(jautotune.load_table(a), gpu))
    assert strip_framework(merged)["cpu"] == ta["backends"]["cpu"]["entries"]
    hosts = tautotune.merge_host_tables([a, b])
    assert strip_framework(hosts) == strip_framework(
        jautotune.merge_host_tables([a, b]))
    out = tmp_path / "m.json"
    tautotune.save_table(hosts, out)
    assert tautotune.load_table(out) == hosts


def test_a_malformed_explicit_table_fails_and_the_default_degrades(
        tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 3, "backends": {"npu": {
        "entries": {"reduce/f32/4": {"path": "fused"}}}}}))
    knob = tmp_path / "knob.json"
    knob.write_text(json.dumps({"version": 3, "backends": {"cpu": {
        "entries": {"ssd/f32/4": {"path": "tile",
                                  "tuning": {"block_q": 4, "bogus": 1}}}}}}))
    for path in (bad, knob, tmp_path / "missing.json"):
        for pkg, pol in ((tpolicy, {"device": CPU}), (jpolicy, {})):
            with pytest.raises(ValueError, match="unusable"):
                pkg.KernelPolicy(autotune_table=str(path)).resolve(
                    op="reduce", n=16, **pol)
    monkeypatch.setattr(tautotune, "DEFAULT_TABLE_PATH", bad)
    tautotune.invalidate_cache()
    assert tautotune.current_table(tpolicy.KernelPolicy()) is None
    got = tpolicy.KernelPolicy().resolve(op="reduce", n=16, device=CPU)
    assert got == tautotune.heuristic("reduce", 16, device=CPU)


def test_a_gpu_section_leaves_cpu_resolution_alone(tmp_path):
    cpu_t, both = tmp_path / "cpu.json", tmp_path / "both.json"
    table = synthetic_table(cpu_t, seed=5)
    gpu = {"torch": "x", "entries": {
        k: {"path": "tile_gpu", "us": {"tile_gpu": 0.1},
            "tuning": {"block_n": 512} if k.startswith("scan") else {}}
        for k in table["backends"]["cpu"]["entries"]}}
    both.write_text(json.dumps({"version": 3, "backends": {
        **table["backends"], "gpu": gpu}}))
    for op, level, n, _, td in calls():
        a = tpolicy.KernelPolicy(autotune_table=str(cpu_t),
                                 interpret_fallback="silent")
        b = tpolicy.KernelPolicy(autotune_table=str(both),
                                 interpret_fallback="silent")
        ra = a.resolve(op=op, n=n, dtype=td, level=level, device=CPU)
        rb = b.resolve(op=op, n=n, dtype=td, level=level, device=CPU)
        assert (ra, ra.tuning) == (rb, rb.tuning)


def test_measure_table_emits_the_reference_s_bucket_keys():
    kw = dict(bands=(4, 5), iters=1)
    got = tautotune.measure_table(dtypes=(torch.float32,), device="cpu",
                                  **kw)
    want = jautotune.measure_table(dtypes=(jnp.float32,), **kw)
    assert set(got["backends"]) == set(want["backends"]) == {"cpu"}
    gs, ws = got["backends"]["cpu"], want["backends"]["cpu"]
    assert set(gs["entries"]) == set(ws["entries"])
    assert gs["torch"] == torch.__version__
    for key, ent in gs["entries"].items():
        assert set(ent["us"]) == set(ws["entries"][key]["us"])
        assert ent["path"] == min(ent["us"], key=ent["us"].get)


def test_the_logdepth_sweep_persists_its_spec_on_plain_passes():
    table = tautotune.measure_table(ops=("scan", "weighted_scan"),
                                    bands=(8,), dtypes=(torch.float32,),
                                    iters=1, sweep_interpret=True,
                                    max_candidates=2, device="cpu")
    for key, ent in table["backends"]["cpu"]["entries"].items():
        op = key.split("/")[0]
        assert "tile_logdepth" in ent["us"]
        assert len(ent["sweep"]) == 2
        assert all(k.startswith("tile_logdepth:") for k in ent["sweep"])
        tpolicy.TuneSpec(op, ent["tuning"])


def test_the_checked_in_table_is_fresh_and_the_port_s_own():
    assert tautotune.check_default() == []
    table = tautotune.load_table(tautotune.DEFAULT_TABLE_PATH)
    assert set(table["backends"]) == {"cpu"}
    assert "torch" in table["backends"]["cpu"]
    assert tautotune.check_report() == []


def test_cli_check_and_tiny_write(tmp_path, capsys):
    assert tautotune.main(["--check"]) == 0
    out = tmp_path / "t.json"
    assert tautotune.main(["--write", "--sweep-budget", "tiny", "--out",
                           str(out), "--device", "cpu"]) == 0
    table = tautotune.load_table(out)
    assert table["version"] == 3
    assert len(table["backends"]["cpu"]["entries"]) == 6
    assert tautotune.main(["--check", "--out", str(out)]) == 0
    stale = tmp_path / "s.json"
    stale.write_text(json.dumps({"version": 3, "backends": {"cpu": {
        "entries": {"reduce/f32/30": {"path": "fused"}}}}}))
    assert tautotune.main(["--check", "--out", str(stale)]) == 1
    assert "stale" in capsys.readouterr().out
