"""The port's kernel policy (``repro_torch.core.policy``) against the JAX
package's ``repro.core.policy`` on the CPU.

``KernelPolicy.from_spec`` field by field over bare labels, ``op=path``
lists, dotted knobs, JSON and aliases; the same bad specs raising
``ValueError`` in both; ``default_policy()`` under the same env vars; the
context-var scoping; the grep guard that only ``core/policy.py`` reads the
env vars; the memo; the tuning knobs the Hopper kernels take (a knob they do
not take warns once and is dropped); the config shims, the CLI merge and
the public surface of ``repro_torch.ops``. Resolution against one shared
table lives in ``tests/test_torch_autotune.py``.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.ops as rops
import repro_torch.ops as tops
from repro.core import policy as jpolicy
from repro_torch.configs import llama3_2_1b as tllama
from repro_torch.core import policy as tpolicy
from repro_torch.core.policy import KernelPolicy, TuneSpec
from repro_torch.kernels import layout as tlayout
from repro_torch.models import build_lm
from repro_torch.models.common import init_params
from repro_torch.models.layers import ModelConfig
from repro_torch.obs import using_obs
from repro_torch.optim import OptConfig
from repro_torch.serving import ServeConfig, ServingEngine

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
CPU = torch.device("cpu")

SPECS = (
    "auto", "fused", "tile", "baseline", "interpret", "xla_tile",
    "tile_logdepth", "tile_gpu", "tile_tpu",
    "attention=fused", "fused,ssd=tile", "reduce=baseline,scan=tile",
    "baseline,attention=fused", "ssd_scan=tile_logdepth",
    "segmented_reduce=xla_tile", "tile,ssd.q=32",
    "tile_logdepth,scan.block_n=512,scan.radix=8",
    "ssd_scan.q=64,ssd.radix=32", "attention.block_q=128",
    "weighted_scan.q=128,weighted_scan.fan_in=32",
    '{"path": "auto", "autotune": "off"}',
    '{"backend": "cpu", "interpret_fallback": "error"}',
    '{"op_tuning": {"ssd": {"q": 32}}, "path": "tile"}',
    '{"op_paths": {"reduce": "baseline"}, "autotune_table": "/t.json"}',
    '{"op_tuning": {"ssd_scan": {"q": 32}, "ssd": {"radix": 8}}}',
)
BAD_SPECS = (
    "bogus", "bogus=fused", "reduce=nope", "attention.bogus=4",
    "ssd.q=0", "ssd.q=-16", "rmsnorm.q=4", '{"backend": "npu"}',
    '{"autotune": "sometimes"}', '{"interpret_fallback": "loud"}',
    '{"op_tuning": {"ssd": {"q": 32}, "ssd_scan": {"q": 64}}}',
    '["tile"]',
)


def fields(pol) -> dict:
    """A policy's fields with the TuneSpecs as (op, knobs) pairs."""
    out = {f.name: getattr(pol, f.name) for f in dataclasses.fields(pol)}
    out["op_tuning"] = tuple((op, ts.op, ts.knobs)
                             for op, ts in pol.op_tuning)
    return out


@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_matches_the_reference(spec):
    assert fields(KernelPolicy.from_spec(spec)) == \
        fields(jpolicy.KernelPolicy.from_spec(spec))
    base_t = KernelPolicy(path="baseline", op_paths={"ssd": "fused"},
                          op_tuning={"ssd": {"q": 16}})
    base_j = jpolicy.KernelPolicy(path="baseline", op_paths={"ssd": "fused"},
                                  op_tuning={"ssd": {"q": 16}})
    assert fields(KernelPolicy.from_spec(spec, base=base_t)) == \
        fields(jpolicy.KernelPolicy.from_spec(spec, base=base_j))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_bad_specs_raise_in_both(spec):
    with pytest.raises(ValueError):
        jpolicy.KernelPolicy.from_spec(spec)
    with pytest.raises(ValueError):
        KernelPolicy.from_spec(spec)


def test_schema_and_labels_are_the_reference_s():
    for name in ("DISPATCH_PATHS", "KERNEL_PATHS", "KNOWN_OPS", "OP_ALIASES",
                 "KNOB_SCHEMA", "BACKENDS", "AUTOTUNE_MODES",
                 "INTERPRET_FALLBACKS", "ENV_PATH", "ENV_AUTOTUNE",
                 "ENV_TABLE"):
        assert getattr(tpolicy, name) == getattr(jpolicy, name), name
    assert TuneSpec("ssd_scan", {"q": 32}).op == "ssd"
    assert TuneSpec.from_spec("ssd", "q=32,radix=8").label() == \
        jpolicy.TuneSpec.from_spec("ssd", "q=32,radix=8").label()


@pytest.mark.parametrize("env", [
    {}, {"REPRO_KERNEL_PATH": "baseline"},
    {"REPRO_KERNEL_PATH": "FUSED,SSD=TILE", "REPRO_AUTOTUNE": "off"},
    {"REPRO_AUTOTUNE": "0", "REPRO_AUTOTUNE_TABLE": "/tmp/t.json"},
    {"REPRO_KERNEL_PATH": "tile,ssd.q=32", "REPRO_AUTOTUNE": "static"},
    {"REPRO_KERNEL_PATH": '{"path": "tile", "backend": "cpu"}'},
])
def test_default_policy_matches_the_reference(env, monkeypatch):
    for var in (tpolicy.ENV_PATH, tpolicy.ENV_AUTOTUNE, tpolicy.ENV_TABLE):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert fields(tpolicy.default_policy()) == \
        fields(jpolicy.default_policy())
    assert tpolicy.get_policy() == tpolicy.default_policy()


def test_env_change_clears_the_memo(monkeypatch):
    monkeypatch.delenv(tpolicy.ENV_PATH, raising=False)
    got = tpolicy.get_policy().resolve(op="reduce", n=16, device=CPU)
    assert tpolicy._MEMO
    monkeypatch.setenv(tpolicy.ENV_PATH, "xla_tile")
    assert tpolicy.get_policy().resolve(op="reduce", n=16,
                                        device=CPU) == "xla_tile" != got


def test_nested_using_policy_restores():
    outer = tpolicy.get_policy()
    with tpolicy.using_policy("fused") as p1:
        assert p1.path == "fused" and tpolicy.get_policy() is p1
        with tpolicy.using_policy("ssd=baseline") as p2:
            assert p2.path == "fused" and p2.for_op("ssd") == "baseline"
        assert tpolicy.get_policy() is p1
    assert tpolicy.get_policy() == outer


def test_using_policy_restores_on_exception():
    outer = tpolicy.get_policy()
    with pytest.raises(KeyError):
        with tpolicy.using_policy("baseline"):
            raise KeyError("x")
    assert tpolicy.get_policy() == outer


def test_set_policy_token_reset():
    outer = tpolicy.get_policy()
    token = tpolicy.set_policy("tile")
    assert tpolicy.get_policy().path == "tile"
    tpolicy.reset_policy(token)
    assert tpolicy.get_policy() == outer
    token = tpolicy.set_policy(None)
    assert tpolicy.get_policy() == tpolicy.default_policy()
    tpolicy.reset_policy(token)


def test_env_vars_read_only_in_policy_module():
    """Outside ``core/policy.py`` no module of the port (nor chip_smoke.py
    and the timing scripts) reads the selection env vars."""
    pat = re.compile(
        r"(?:os\.environ(?:\.get)?|os\.getenv)\s*[\[(][^)\]]*"
        r"(?:REPRO_KERNEL_PATH|REPRO_AUTOTUNE|ENV_PATH|ENV_AUTOTUNE"
        r"|ENV_TABLE)"
        r"|os\.environ\.get\(\w+\)\s+for\s+\w+\s+in\s+_ENV_NAMES"
        r"|os\.environ\._data|encodekey", re.DOTALL)
    root = SRC.parents[1]
    files = sorted(SRC.rglob("*.py")) + sorted(root.glob("*.py"))
    offenders = [str(p.relative_to(root)) for p in files
                 if p != SRC / "core" / "policy.py"
                 and pat.search(p.read_text())]
    assert not offenders, offenders
    assert pat.search((SRC / "core" / "policy.py").read_text())


def test_policy_is_hashable_and_memoised():
    a = KernelPolicy.from_spec("tile,ssd.q=32")
    b = KernelPolicy(path="tile", op_tuning={"ssd": {"q": 32}})
    assert a == b and hash(a) == hash(b) and len({a, b}) == 1
    import copy
    import pickle

    for c in (pickle.loads(pickle.dumps(a)), copy.deepcopy(a)):
        assert c == a and hash(c) == hash(a)
        assert "_hash" not in pickle.loads(pickle.dumps(a)).__getstate__()
    tpolicy.invalidate_cache()
    r1 = a.resolve(op="ssd", n=500, dtype=torch.bfloat16, device=CPU)
    r2 = b.resolve(op="ssd", n=500, dtype=torch.bfloat16, device=CPU)
    assert r1 is r2
    assert tops.KernelPolicy is KernelPolicy
    assert tpolicy.as_policy("fused") is tpolicy.as_policy("fused")


def test_resolution_event_fires_on_every_memoised_call():
    pol = KernelPolicy(path="baseline")
    with using_obs() as sess:
        for _ in range(3):
            pol.resolve(op="scan", n=64, dtype=torch.float32, device=CPU)
    assert len(sess.events.events("resolution")) == 3


def test_labels_on_a_cpu_tensor():
    pol = KernelPolicy(path="tile", interpret_fallback="silent")
    assert pol.resolve(op="reduce", n=64, device=CPU) == "interpret"
    assert KernelPolicy(path="tile", backend="cpu").resolve(
        op="reduce", n=64, device=CPU) == "interpret"
    with pytest.raises(RuntimeError, match="interpret_fallback"):
        KernelPolicy(path="tile", interpret_fallback="error").resolve(
            op="reduce", n=64, device=CPU)
    with pytest.raises(RuntimeError, match="tile_tpu"):
        KernelPolicy(path="tile_tpu").resolve(op="reduce", n=64, device=CPU)
    with pytest.raises(RuntimeError, match="tile_gpu"):
        KernelPolicy(path="tile_gpu").resolve(op="reduce", n=64, device=CPU)
    with pytest.raises(RuntimeError, match="tile_gpu"):
        KernelPolicy(path="tile", backend="gpu").resolve(op="reduce", n=64,
                                                         device=CPU)
    assert KernelPolicy(path="xla_tile").resolve(
        op="reduce", n=64, device=CPU) == "xla_tile"
    assert KernelPolicy(path="xla_tile").resolve(
        op="segmented_reduce", n=64, level="kernel", device=CPU) == "fused"
    with pytest.raises(ValueError, match="kernel path"):
        KernelPolicy().resolve(op="reduce", n=64, level="kernel",
                               explicit="baseline", device=CPU)


@pytest.mark.parametrize("spec", ["auto", "tile", "tile_logdepth",
                                  KernelPolicy(path="tile",
                                               interpret_fallback="silent")])
def test_a_cuda_tensor_without_hopper_raises(spec, monkeypatch):
    """A CUDA tensor on a card other than compute capability 9.0 has no
    kernel: ``auto``, ``tile`` and ``tile_logdepth`` raise for it instead
    of running the plain versions, at both levels; an explicit plain or
    torch label, or ``backend="cpu"``, still resolves."""
    from repro_torch import device as tdevice
    from repro_torch.kernels import backend as tbackend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tdevice, "_capability", lambda index: (8, 0))
    tpolicy.invalidate_cache()
    cuda = torch.device("cuda:0")
    assert tbackend.native_tile_backend(cuda) is None
    pol = tpolicy.as_policy(spec)
    for level in ("dispatch", "kernel"):
        op = "scan" if level == "dispatch" else "segmented_scan"
        with pytest.raises(RuntimeError, match="compute capability 9.0"):
            pol.resolve(op=op, n=4096, dtype=torch.float32, level=level,
                        device=cuda)
    for label in ("interpret", "fused"):
        assert pol.resolve(op="scan", n=4096, dtype=torch.float32,
                           explicit=label, device=cuda) == label
    assert KernelPolicy(path="baseline").resolve(
        op="scan", n=4096, device=cuda) == "baseline"
    assert KernelPolicy(path="tile", backend="cpu").resolve(
        op="scan", n=4096, device=cuda) == "interpret"
    tpolicy.invalidate_cache()


def test_tile_downgrade_warns_once():
    tpolicy._WARNED.discard("downgrade:tile")
    tpolicy.invalidate_cache()
    pol = KernelPolicy(path="tile")
    with pytest.warns(UserWarning, match="plain version"):
        pol.resolve(op="scan", n=64, device=CPU)
    tpolicy.invalidate_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pol.resolve(op="scan", n=64, device=CPU)


# ---------------------------------------------------------------------------
# tuning: the knobs the Hopper kernels take


def test_tuning_follows_the_label_and_clamps():
    lg = KernelPolicy.from_spec("tile_logdepth,ssd.q=32",
                                base=KernelPolicy(interpret_fallback="silent"))
    spec = lg.resolve(op="ssd", n=1000, device=CPU).tuning
    assert spec.as_dict() == {"q": 32, "radix": 16, "fan_in": 16}
    # clamped against the sequence: whole tiles of 16
    assert lg.resolve(op="ssd", n=20, device=CPU).tuning.get("q") == 32
    assert lg.resolve(op="ssd", n=10, device=CPU).tuning.get("q") == 16
    # the linear scans take no knob; the plain versions neither
    assert KernelPolicy(path="interpret").resolve(
        op="scan", n=1 << 12, device=CPU).tuning.as_dict() == {}
    assert KernelPolicy(path="baseline").resolve(
        op="ssd", n=1 << 12, device=CPU).tuning.as_dict() == {}
    scan = KernelPolicy(path="tile_logdepth", interpret_fallback="silent",
                        op_tuning={"scan": {"block_n": 100}}).resolve(
        op="scan", n=1 << 12, device=CPU).tuning
    assert scan.as_dict() == {"block_n": 96, "radix": 16, "fan_in": 16}
    wq = KernelPolicy(path="tile_logdepth", interpret_fallback="silent",
                      op_tuning={"weighted_scan": {"q": 100}}).resolve(
        op="weighted_scan", n=1 << 12, device=CPU).tuning
    assert wq.get("q") == 64                      # a power of two <= 128
    assert tlayout.clamp_spec("gpu", "weighted_scan", {"q": 512})["q"] == \
        tlayout.WEIGHTED_MAX_Q


def test_a_knob_no_hopper_kernel_takes_warns_once_and_is_dropped():
    tpolicy._WARNED.discard("knob:attention.block_q")
    tpolicy.invalidate_cache()
    pol = KernelPolicy.from_spec("tile_logdepth,attention.block_q=128,"
                                 "scan.num_warps=8",
                                 base=KernelPolicy(
                                     interpret_fallback="silent"))
    assert pol.op_tuning[0][1].as_dict() == {"block_q": 128}   # accepted
    with pytest.warns(UserWarning, match="attention.block_q"):
        spec = pol.resolve(op="attention", n=256, device=CPU).tuning
    assert spec.as_dict() == {}
    with pytest.warns(UserWarning, match="scan.num_warps"):
        spec = pol.resolve(op="scan", n=256, device=CPU).tuning
    assert "num_warps" not in spec.as_dict()
    tpolicy.invalidate_cache()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pol.resolve(op="attention", n=512, device=CPU)


def test_kernel_invoke_reports_the_geometry_that_ran():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 1000)).astype(np.float32))
    with using_obs() as sess:
        tops.scan(x, policy=KernelPolicy.from_spec(
            "tile_logdepth,scan.block_n=128,scan.fan_in=8",
            base=KernelPolicy(interpret_fallback="silent")))
        tops.scan(x, policy="interpret")
    inv = [(e["path"], e["tuning"])
           for e in sess.events.events("kernel_invoke")]
    assert inv == [("tile_logdepth", {"block_n": 128, "radix": 16,
                                      "fan_in": 8}),
                   ("interpret", {})]
    res = [e["tuning"] for e in sess.events.events("resolution")
           if e["level"] == "kernel"]
    assert res == [inv[0][1], {}]


def test_tuning_tables_are_within_the_schema():
    for table in (tlayout.DEFAULT_TUNING, tlayout.CANDIDATE_TUNING,
                  tlayout.LOGDEPTH_CANDIDATE_TUNING):
        assert set(table) == {"gpu"}
        for op, specs in table["gpu"].items():
            for spec in (specs if isinstance(specs, tuple) else (specs,)):
                TuneSpec(op, spec)
    for label, ops in tlayout.KERNEL_KNOBS.items():
        for op, knobs in ops.items():
            assert set(knobs) <= set(tlayout.DEFAULT_TUNING["gpu"][op])
    for op, specs in tlayout.LOGDEPTH_CANDIDATE_TUNING["gpu"].items():
        assert specs[0] == tlayout.default_tuning("gpu", op)
    assert tlayout.candidate_tuning("gpu", "ssd")[0] == {"q": 64}


# ---------------------------------------------------------------------------
# configs, CLIs, the public surface


@pytest.mark.parametrize("cls", [ModelConfig, OptConfig, ServeConfig])
def test_config_kernel_path_shim_warns_once_and_coerces(cls):
    kwargs = dict(name="t", family="dense", n_layers=1, d_model=8,
                  vocab=16) if cls is ModelConfig else {}
    tpolicy._WARNED.discard(f"deprecated:{cls.__name__}.kernel_path")
    with pytest.warns(DeprecationWarning, match="kernel_path"):
        cfg = cls(**kwargs, kernel_path="fused")
    assert cfg.policy == KernelPolicy(path="fused")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        cfg2 = cls(**kwargs, kernel_path="baseline")
    assert cfg2.policy == KernelPolicy(path="baseline")
    assert cls(**kwargs, policy="tile,ssd.q=32").policy == \
        KernelPolicy(path="tile", op_tuning={"ssd": {"q": 32}})
    assert cls(**kwargs, policy="fused",
               kernel_path="baseline").policy == KernelPolicy(path="fused")
    assert cls(**kwargs).policy is None
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        assert dataclasses.replace(cfg).policy == cfg.policy


@pytest.mark.parametrize("args", [
    (None, None, None), ("fused", None, None), (None, "baseline", None),
    ("fused", "baseline", None), ("tile", None, "ssd.q=32,ssd.radix=8"),
    (None, None, "attention.block_q=128"),
])
def test_policy_from_cli_matches_the_reference(args, monkeypatch):
    for var in (tpolicy.ENV_PATH, tpolicy.ENV_AUTOTUNE, tpolicy.ENV_TABLE):
        monkeypatch.delenv(var, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = tpolicy.policy_from_cli(*args[:2], "k", tune_arg=args[2])
        want = jpolicy.policy_from_cli(*args[:2], "k", tune_arg=args[2])
    assert (got is None) == (want is None)
    if got is not None:
        assert fields(got) == fields(want)
    with pytest.raises(ValueError, match="op.knob"):
        tpolicy.policy_from_cli(None, None, "k", tune_arg="ssd=tile")


def test_ops_surface_is_the_reference_s_but_dist():
    assert tops.__all__ == rops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name


def test_ops_path_kwarg_warns_once_and_works():
    x = torch.ones(2, 100)
    tpolicy._WARNED.discard("deprecated:repro_torch.ops.path")
    with pytest.warns(DeprecationWarning, match="policy="):
        got = tops.reduce(x, path="fused")
    torch.testing.assert_close(got, torch.full((2,), 100.0))
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        got = tops.reduce(x, path="baseline")
    torch.testing.assert_close(got, torch.full((2,), 100.0))


def test_engine_binds_the_policy_of_its_construction():
    """With ``ServeConfig.policy`` None the engine runs every step under the
    policy active when it was built, whatever is active later."""
    cfg = tllama.SMOKE
    bundle = build_lm(cfg)
    params = init_params(bundle.params_pspec,
                         torch.Generator().manual_seed(0), cfg.dtype,
                         device="cpu")
    with tpolicy.using_policy("tile"):
        eng = ServingEngine(bundle, params, ServeConfig(slots=1, max_new=2))
    assert eng.policy == tpolicy.KernelPolicy.from_spec(
        "tile", base=tpolicy.default_policy())
    from repro_torch.serving import Request

    with tpolicy.using_policy("fused"), using_obs() as sess:
        eng.run([Request(uid=0, prompt=np.arange(3, 9, dtype=np.int32))])
    paths = {e["chosen_path"] for e in sess.events.events("resolution")
             if e["op"] == "rmsnorm"}
    assert paths == {"interpret"}          # tile's, not fused's
