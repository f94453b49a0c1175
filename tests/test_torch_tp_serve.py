"""Sharded serving on a ``(data, model)`` mesh (``ServingEngine(mesh_ctx=)``
and ``make_serve_step(bundle, mesh_ctx=)``: slots over ``data``, heads,
``ff`` columns, SSM heads and vocab over ``model``, the sequence-sharded KV
cache) against the JAX package's unsharded engine and steps on the CPU.

One module-scoped gloo world of 4 processes (a ``file://`` init in a
temporary directory, as ``tests/test_torch_sharded_serve.py``) on
``data=2,model=2`` takes the reference's SMOKE parameters (f32,
``init_params(PRNGKey(0))``) placed under the rules' specs (FSDP over
``data`` too, so ``serving_params`` gathers over it) and

* serves 4 requests on 2 slots (one a data rank) with llama3.2, mamba2
  (8 SSM heads, 4 a rank) and zamba2 on the ring and the paged cache,
  internvl2 text-only on the ring, and llama3.2 on the ring under the
  production rules' ``seq_shard=True`` (the ring's rows split over
  ``model``), beside the port's unsharded engine in the same process;
* runs the sharded wave steps under ``seq_shard=True``: llama3.2 and
  mamba2, a prefill of 4 rows x 12 tokens into a cache of 16 rows (8 a
  rank) and 3 decode steps, and of one row (4 cache rows a rank);
* records each rank's parameter bytes against the whole model's and the
  raises of the families and shapes the path does not take;
* merges random partial attention over 1, 2 and 4 ranges of a cache, one
  a rank of the group, by ``TensorParallel.merge_attention``.

The reference's unsharded engines and steps run here meanwhile; each test
reads one result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models.common import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.engine import _pad_cache_seq as jpad_cache_seq
from repro.training import make_serve_step as jmake_serve_step

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300          # seconds, the world
ENCDEC = "seamless-m4t-medium"
ARCHS = ("llama3.2-1b", "mamba2-1.3b", "zamba2-2.7b", "internvl2-76b",
         "qwen3-moe-235b-a22b", "grok-1-314b", ENCDEC)
MOE_ARCHS = ("qwen3-moe-235b-a22b", "grok-1-314b")
# (arch, cache kind, rules): "mesh" the default table, "seq" the production
# rules with seq_shard=True
RUNS = [(a, k, "mesh") for a in ARCHS[:3] + MOE_ARCHS
        for k in ("ring", "paged")] + [
    ("internvl2-76b", "ring", "mesh"), ("llama3.2-1b", "ring", "seq")]
SERVE = dict(slots=2, max_new=4, eos_token=-1, prefill_chunk=4)
WAVE_ARCHS = ("llama3.2-1b", "mamba2-1.3b")
# (rows, prompt tokens, cache rows), 3 decode steps after the prefill
WAVES = ((4, 12, 16), (1, 12, 16))
DECODES = 3
# the encoder-decoder's sharded wave steps: (rules, rows), each with
# ENCDEC_FRAMES frames and the prompt tokens and cache rows of WAVES
ENCDEC_WAVES = (("seq", 4), ("seq", 1), ("mesh", 4))
ENCDEC_FRAMES = 16
TOL = 1e-5
# the merge's groups of ranges: the mesh dims a cache's rows split over
MERGE_AXES = ("", "model", "data", "data,model")
MERGE_WINDOWS = (None, 5)


def _prompts(vocab: int) -> list:
    """4 prompts; the third extends the first (a paged snapshot load)."""
    rng = np.random.default_rng(0)
    p = [rng.integers(3, vocab, size=n, dtype=np.int32) for n in (6, 9, 7)]
    return [p[0], p[1], np.concatenate([p[0], p[2][:3]]), p[2]]


def _wave_tokens(vocab: int, rows: int, seq: int) -> np.ndarray:
    rng = np.random.default_rng(rows)
    return rng.integers(3, vocab, size=(rows, seq + DECODES),
                        dtype=np.int64)


def _frames(d: int, rows: int) -> np.ndarray:
    rng = np.random.default_rng(100 + rows)
    return rng.standard_normal((rows, ENCDEC_FRAMES, d)).astype(np.float32)


WORKER = """
import json, os, re, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "init"), rank=rank, world_size=world)
from repro_torch import configs, tree
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import build
from repro_torch.models.common import params_from_numpy, partition_specs
from repro_torch.parallel import make_context
from repro_torch.parallel.mesh_context import MeshContext
from repro_torch.parallel.sharded_state import place_tree
from repro_torch.serving import Request, ServeConfig, ServingEngine
from repro_torch.serving.engine import serving_params
from repro_torch.training import make_serve_step

spec = json.loads(sys.argv[4])
ctx = make_context("data=2,model=2", device="cpu")
contexts = {"mesh": ctx, "seq": MeshContext(
    mesh=ctx.mesh, rules=mesh_lib.make_rules(ctx.mesh, fsdp=False,
                                             seq_shard=True))}
out, info = {}, {"coordinate": list(ctx.mesh.get_coordinate())}


def named(t):
    # "['blocks'][0]['attn']['wq']" -> "blocks/0/attn/wq"
    return {"/".join(re.findall(r"[\\w.-]+", k)): v
            for k, v in tree.items(t) if isinstance(v, torch.Tensor)}


def load(arch):
    cfg = configs.get(arch).SMOKE
    bundle = build(cfg)
    z = np.load(os.path.join(d, arch + ".npz"))
    flat = {}
    for k in z.files:       # "a/b/c" -> nested dicts, the stacked layout
        node = flat
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = z[k]
    params = params_from_numpy(flat, cfg, device="cpu")
    specs = partition_specs(bundle.params_pspec, rules=ctx.rules,
                            fsdp_ok=True)
    placed = place_tree(params, tree.map_tree(
        lambda _, s: ctx.named_sharding(s), bundle.params_pspec, specs))
    return cfg, bundle, params, placed


def serve(bundle, params, kind, mesh_ctx, prompts):
    eng = ServingEngine(bundle, params, ServeConfig(
        cache_kind=kind, page_rows=8, **spec["serve"]), mesh_ctx=mesh_ctx)
    seen = []
    sample = eng._sample

    def keep(logits):
        seen.append(logits.float().numpy().copy())
        return sample(logits)

    eng._sample = keep
    res = eng.run([Request(uid=i, prompt=np.asarray(p, np.int32))
                   for i, p in enumerate(prompts)])
    return eng, {r.uid: [int(t) for t in r.tokens] for r in res}, seen


loaded = {}
for arch, kind, rules in spec["runs"]:
    if arch not in loaded:
        loaded[arch] = load(arch)
    cfg, bundle, params, placed = loaded[arch]
    prompts = spec["prompts"][arch]
    eng, toks, logits = serve(bundle, placed, kind, contexts[rules], prompts)
    key = f"{arch}/{kind}/{rules}"
    cache = eng._cache
    info[key] = {"tokens": toks, "trace": eng.trace,
                 "stats": eng.compile_stats(),
                 "cache": {k: list(v.shape) for k, v in named(cache).items()}}
    _, utoks, ulogits = serve(bundle, params, kind, None, prompts)
    info[key]["unsharded_tokens"] = utoks
    out[key] = np.stack(logits)
    out[key + "/unsharded"] = np.stack(ulogits)

for arch in spec["archs"]:
    if arch not in loaded:
        loaded[arch] = load(arch)
    cfg, bundle, params, placed = loaded[arch]
    mine = serving_params(placed, bundle, ctx)
    whole = serving_params(params, bundle, None)
    info["bytes/" + arch] = {
        "rank": sum(t.numel() * t.element_size() for t in tree.leaves(mine)),
        "whole": sum(t.numel() * t.element_size()
                     for t in tree.leaves(whole)),
        "leaves": {k: [t.numel(), w.numel()] for (k, t), w in
                   zip(named(mine).items(), named(whole).values())}}

seq = contexts["seq"]
for arch in spec["wave_archs"]:
    cfg, bundle, params, placed = loaded[arch]
    mine = serving_params(placed, bundle, seq)
    prefill, decode = make_serve_step(bundle, mesh_ctx=seq)
    for rows, s, cap in spec["waves"]:
        tok = torch.from_numpy(np.asarray(spec["wave_tokens"][arch][str(rows)]))
        with torch.inference_mode():
            lg, cache = prefill(mine, {"tokens": tok[:, :s]}, cap)
            got = [lg[:, -1].numpy().copy()]
            for i in range(spec["decodes"]):
                lg, cache = decode(mine, cache,
                                   {"tokens": tok[:, s + i:s + i + 1]})
                got.append(lg[:, -1].numpy().copy())
        key = f"wave/{arch}/{rows}"
        out[key] = np.stack(got)
        info[key] = {"rows": cache.get("rows"), "cache": {
            k: list(v.shape) for k, v in named(cache).items()}}

# the encoder-decoder's wave steps, its rows of the frames and tokens
cfg, bundle, params, placed = loaded[spec["encdec"]]
_, s, cap = spec["waves"][0]
for rules, rows in spec["encdec_waves"]:
    mctx = contexts[rules]
    mine = serving_params(placed, bundle, mctx)
    prefill, decode = make_serve_step(bundle, mesh_ctx=mctx)
    tok = torch.tensor(spec["encdec_tokens"][str(rows)])
    frames = torch.tensor(spec["encdec_frames"][str(rows)])
    with torch.inference_mode():
        lg, cache = prefill(mine, {"frames": frames, "tokens": tok[:, :s]},
                            cap)
        got = [lg[:, -1].numpy().copy()]
        for i in range(spec["decodes"]):
            lg, cache = decode(mine, cache,
                               {"tokens": tok[:, s + i:s + i + 1]})
            got.append(lg[:, -1].numpy().copy())
    key = f"encdec/{rules}/{rows}"
    out[key] = np.stack(got)
    info[key] = {"rows": cache.get("rows"), "cache": {
        k: list(v.shape) for k, v in named(cache).items()}}

# what still raises: the encoder-decoder's engine (no block step; the wave
# raises under lockstep), slots that data does not divide
try:
    ServingEngine(bundle, placed, ServeConfig(**spec["serve"]), mesh_ctx=ctx)
except ValueError as e:
    info["raises/encdec/engine"] = str(e)
try:
    ServingEngine(loaded["llama3.2-1b"][1], loaded["llama3.2-1b"][2],
                  ServeConfig(**dict(spec["serve"], slots=3)), mesh_ctx=ctx)
except ValueError as e:
    info["raises/slots"] = str(e)

# random partials over this rank's range of a cache of 24 rows (uneven
# cuts; the early queries of slot 0 see no row of the later ranges),
# merged across the group of ranges
from repro_torch.models.xla_attention import decode_attention, \
    decode_attention_part
from repro_torch.parallel.tensor_parallel import TensorParallel

for axes in spec["merge_axes"]:
    for window in spec["merge_windows"]:
        seq_axes = tuple(a for a in axes.split(",") if a)
        gen = torch.Generator().manual_seed(len(seq_axes))
        b, t, hq, hkv, dh, s = 3, 4, 4, 2, 8, 24
        q = torch.randn(b, t, hq, dh, generator=gen)
        k = torch.randn(b, s, hkv, dh, generator=gen)
        v = torch.randn(b, s, hkv, dh, generator=gen)
        lens = torch.randint(1, s + 1, (b, t), generator=gen)
        lens[0] = torch.arange(1, t + 1)
        tp = TensorParallel(mesh=ctx.mesh, dtype=torch.float32,
                            inference=True, seq_axes=seq_axes, kv_rows=s)
        idx, parts = tp.index_in(seq_axes)
        cuts = [0] + sorted(torch.randperm(s - 1, generator=gen)[:parts - 1]
                            .add(1).tolist()) + [s]
        a, c = cuts[idx], cuts[idx + 1]
        got = tp.merge_attention(*decode_attention_part(
            q, k[:, a:c], v[:, a:c], lens, start=a, window=window))
        key = f"merge/{axes}/{window}"
        out[key] = got.numpy()
        out[key + "/whole"] = decode_attention(q, k, v, lens,
                                               window=window).numpy()
        info[key] = {"parts": parts, "range": [a, c]}

np.savez(os.path.join(d, f"r{rank}.npz"), **out)
with open(os.path.join(d, f"r{rank}.json"), "w") as f:
    json.dump(info, f)
dist.barrier()
dist.destroy_process_group()
"""


def _env() -> dict:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    for key in ("JAX_PLATFORMS", "HOME", "TMPDIR"):
        if key in os.environ:
            env[key] = os.environ[key]
    return env


def _jcfg(arch: str):
    return dataclasses.replace(jconfigs.get(arch).SMOKE, policy="fused")


def _reference(jb, params, arch: str) -> dict:
    """The reference's unsharded engines (tokens) and wave steps (the
    logits after the prefill and each decode step)."""
    out = {}
    if arch == ENCDEC:
        prefill, decode = jmake_serve_step(jb)
        _, s, cap = WAVES[0]
        for _, rows in ENCDEC_WAVES:
            tok = _wave_tokens(jb.cfg.vocab, rows, s).astype(np.int32)
            lg, cache = prefill(params, {
                "frames": _frames(jb.cfg.d_model, rows),
                "tokens": tok[:, :s]})
            cache = jpad_cache_seq(cache, cap - s)
            got = [np.asarray(lg[:, -1])]
            for i in range(DECODES):
                lg, cache = decode(params, cache,
                                   {"tokens": tok[:, s + i:s + i + 1]})
                got.append(np.asarray(lg[:, -1]))
            out[("encdec", rows)] = np.stack(got)
        return out
    for run_arch, kind, _ in RUNS:
        if run_arch != arch or (arch, kind) in out:
            continue
        eng = JServingEngine(jb, params, JServeConfig(
            scheduler="continuous", cache_kind=kind, page_rows=8,
            policy="fused", **SERVE))
        res = eng.run([JRequest(uid=i, prompt=p)
                       for i, p in enumerate(_prompts(jb.cfg.vocab))])
        out[(arch, kind)] = {str(r.uid): [int(t) for t in r.tokens]
                             for r in res}
    if arch in WAVE_ARCHS:
        prefill, decode = jmake_serve_step(jb)
        for rows, s, cap in WAVES:
            tok = _wave_tokens(jb.cfg.vocab, rows, s).astype(np.int32)
            lg, cache = prefill(params, {"tokens": tok[:, :s]})
            cache = jpad_cache_seq(cache, cap - s)
            got = [np.asarray(lg[:, -1])]
            for i in range(DECODES):
                lg, cache = decode(params, cache,
                                   {"tokens": tok[:, s + i:s + i + 1]})
                got.append(np.asarray(lg[:, -1]))
            out[("wave", arch, rows)] = np.stack(got)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_serve")
    jparams = {}
    for arch in ARCHS:
        jb = jbuild(_jcfg(arch))
        params = jinit_params(jax.random.PRNGKey(0), jb.params_pspec,
                              jb.cfg.dtype)
        jparams[arch] = (jb, params)
        np.savez(d / f"{arch}.npz", **{
            "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)})
    ecfg = jparams[ENCDEC][0].cfg
    spec = {"runs": RUNS, "serve": SERVE, "archs": ARCHS,
            "wave_archs": WAVE_ARCHS, "waves": WAVES, "decodes": DECODES,
            "merge_axes": MERGE_AXES, "merge_windows": MERGE_WINDOWS,
            "encdec": ENCDEC, "encdec_waves": ENCDEC_WAVES,
            "encdec_tokens": {str(r): _wave_tokens(
                ecfg.vocab, r, WAVES[0][1]).tolist()
                for _, r in ENCDEC_WAVES},
            "encdec_frames": {str(r): _frames(ecfg.d_model, r).tolist()
                              for _, r in ENCDEC_WAVES},
            "prompts": {a: [p.tolist() for p in _prompts(
                jparams[a][0].cfg.vocab)] for a in ARCHS},
            "wave_tokens": {a: {str(r): _wave_tokens(
                jparams[a][0].cfg.vocab, r, s).tolist()
                for r, s, _ in WAVES} for a in WAVE_ARCHS}}
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(WORKER), str(r), "4", str(d),
         json.dumps(spec)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(4)]
    # the reference runs while the world does
    ref = {}
    for arch, (jb, params) in jparams.items():
        ref.update(_reference(jb, params, arch))
    failed = {}
    for r, proc in enumerate(procs):
        try:
            _, err = proc.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            failed[r] = f"timed out after {TIMEOUT} s\n{err[-2000:]}"
            continue
        if proc.returncode != 0:
            failed[r] = err[-3000:]
    if failed:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        pytest.fail("; ".join(f"rank {k}: {v}" for k, v in failed.items()))
    return {"ranks": [(dict(np.load(d / f"r{r}.npz")),
                       json.loads((d / f"r{r}.json").read_text()))
                      for r in range(4)], "ref": ref}


@pytest.mark.parametrize("arch,kind,rules", RUNS)
def test_sharded_engine_tokens_match_reference(world, arch, kind, rules):
    """Every rank emits the reference's unsharded engine's tokens (greedy,
    f32), equal to the port's unsharded engine's, with the same
    admit/finish trace on every rank."""
    key = f"{arch}/{kind}/{rules}"
    infos = [info for _, info in world["ranks"]]
    for info in infos:
        assert info[key]["tokens"] == world["ref"][(arch, kind)]
        assert info[key]["tokens"] == info[key]["unsharded_tokens"]
        assert info[key]["trace"] == infos[0][key]["trace"]
    assert all(len(t) == SERVE["max_new"]
               for t in infos[0][key]["tokens"].values())


@pytest.mark.parametrize("arch,kind,rules", RUNS)
def test_sharded_engine_logits_match_unsharded(world, arch, kind, rules):
    """Every tick's logits (the whole slot grid, gathered over ``data`` and
    the vocab over ``model``) within 1e-5 of the port's unsharded engine's,
    and equal on every rank."""
    key = f"{arch}/{kind}/{rules}"
    arrays = [a for a, _ in world["ranks"]]
    for a in arrays[1:]:
        np.testing.assert_array_equal(a[key], arrays[0][key])
    got, want = arrays[0][key], arrays[0][key + "/unsharded"]
    assert got.shape == want.shape and got.shape[1] == SERVE["slots"]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("arch,kind,rules", RUNS)
def test_each_rank_holds_its_part_of_the_cache(world, arch, kind, rules):
    """A rank's cache: its slot of the 2 (``data``); under ``seq_shard``
    half the ring's rows with both KV heads, else its KV heads (llama's 2,
    one a rank; internvl2 alike; zamba2's 4, two a rank); its 4 of the 8
    SSM heads and their conv channels (64 x channels and one B/C group of
    16 each); every page of the paged pools. No CUDA graph under the
    mesh."""
    from repro_torch import configs

    cfg = configs.get(arch).SMOKE
    key = f"{arch}/{kind}/{rules}"
    for _, info in world["ranks"]:
        shapes = info[key]["cache"]
        assert shapes["pos"] == [1]
        if cfg.family in ("dense", "vlm", "hybrid"):
            k = shapes["attn/k"]
            if kind == "paged":             # pages whole, the rank's heads
                assert k[3] == cfg.n_kv_heads // 2
            elif rules == "seq":            # half the ring, every head
                assert k[1] == 1 and k[2] == 8 and k[3] == cfg.n_kv_heads
            else:
                assert k[1] == 1 and k[3] == cfg.n_kv_heads // 2
        if cfg.family in ("ssm", "hybrid"):
            assert shapes["mamba/state"][1:3] == [1, cfg.ssm_heads // 2]
            assert shapes["mamba/conv"][-1] == cfg.d_inner // 2 \
                + 2 * cfg.ssm_state
            if kind == "paged":
                assert shapes["snap/state"][2] == cfg.ssm_heads // 2
        stats = info[key]["stats"]
        assert stats["graphs"] == 0 and "eager" in stats


@pytest.mark.parametrize("arch", WAVE_ARCHS)
@pytest.mark.parametrize("rows", [w[0] for w in WAVES])
def test_sharded_wave_steps_match_reference(world, arch, rows):
    """``make_serve_step(bundle, mesh_ctx=)`` under the production rules'
    ``seq_shard=True``: each rank's logits (its rows: one data
    coordinate's 2 of 4, or the one row on every rank) within 1e-5 of the
    reference's unsharded prefill and decode steps; the KV cache holds half
    its 16 rows a rank (``kv_seq`` -> ``model``, the batch on ``data``), a
    quarter for the one row (``kv_seq`` -> ``data`` x ``model``), every KV
    head."""
    from repro_torch import configs

    cfg = configs.get(arch).SMOKE
    want = world["ref"][("wave", arch, rows)]
    key = f"wave/{arch}/{rows}"
    for arrays, info in world["ranks"]:
        got = arrays[key]
        if rows > 1:
            d = info["coordinate"][0]
            want_rows = want[:, 2 * d:2 * d + 2]
        else:
            want_rows = want
        assert got.shape == want_rows.shape
        np.testing.assert_allclose(got, want_rows, rtol=0, atol=TOL)
        shapes = info[key]["cache"]
        if cfg.family == "dense":
            cap = WAVES[0][2]
            assert info[key]["rows"] == cap
            local = cap // 2 if rows > 1 else cap // 4
            assert shapes["attn/k"] == [cfg.n_layers, max(rows // 2, 1),
                                        local, cfg.n_kv_heads, cfg.dh]
        else:
            assert info[key]["rows"] is None
            assert shapes["mamba/state"][2] == cfg.ssm_heads // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_params_keep_a_model_share(world, arch):
    """``serving_params`` on ``model=2``: every leaf split over ``model``
    (q, k, v, wo, the MLP, the MoE's experts, the encoder-decoder's self
    and cross attention, the Mamba projections and conv, the vocab rows)
    holds half its elements on a rank, the norms and the MoE's router
    whole; the rank's bytes are about half the whole model's."""
    for _, info in world["ranks"]:
        got = info["bytes/" + arch]
        split = {k: v for k, v in got["leaves"].items() if v[0] != v[1]}
        for k, (mine, whole) in split.items():
            if "conv" in k or "in_proj" in k:
                assert mine * 2 > whole and mine < whole, k   # B, C whole
            else:
                assert mine * 2 == whole, k
        whole_leaves = set(got["leaves"]) - set(split)
        assert all("ln" in k or "norm" in k or "stub_proj" in k
                   or "router" in k for k in whole_leaves), whole_leaves
        experts = [k for k in got["leaves"] if "moe/w_" in k]
        assert all(k in split for k in experts)
        assert len(experts) == (3 * 2 if arch in MOE_ARCHS else 0)
        assert got["rank"] < 0.6 * got["whole"]


def test_moe_encdec_and_uneven_slots_raise(world):
    """The MoE serves under a mesh that splits a dim (its engine runs, the
    tests above), and so do the encoder-decoder's wave steps; what still
    raises: the encoder-decoder's engine, which has no block step and
    whose wave fallback raises ``ValueError`` under lockstep, as the
    reference's engine does, and slots that ``data`` does not divide
    (``ValueError`` before any step)."""
    for _, info in world["ranks"]:
        for arch in MOE_ARCHS:
            assert len(info[f"{arch}/ring/mesh"]["tokens"]) == 4
        assert "continuous scheduler" in info["raises/encdec/engine"]
        assert "encdec/seq/4" in info
        assert "3 slots do not divide" in info["raises/slots"]


@pytest.mark.parametrize("rules,rows", ENCDEC_WAVES)
def test_sharded_encdec_steps_match_reference(world, rules, rows):
    """seamless SMOKE through ``make_serve_step(bundle, mesh_ctx=)``: a
    prefill of 16 frames and 12 tokens into 16 self-cache rows and 3 decode
    steps, each rank its rows (2 of 4 by data coordinate, or the one row),
    within 1e-5 of the reference's unsharded ``make_serve_step``. Under
    ``seq_shard`` the self and cross caches' rows are split over ``model``
    (over ``data`` x ``model`` for the one row), every KV head; under the
    default rules the KV heads are split, the rows whole."""
    from repro_torch import configs

    cfg = configs.get(ENCDEC).SMOKE
    want = world["ref"][("encdec", rows)]
    key = f"encdec/{rules}/{rows}"
    cap = WAVES[0][2]
    for arrays, info in world["ranks"]:
        got = arrays[key]
        if rows > 1:
            d = info["coordinate"][0]
            want_rows = want[:, 2 * d:2 * d + 2]
        else:
            want_rows = want
        assert got.shape == want_rows.shape
        np.testing.assert_allclose(got, want_rows, rtol=0, atol=TOL)
        shapes = info[key]["cache"]
        assert info[key]["rows"] == cap
        b = max(rows // 2, 1)
        if rules == "seq":
            parts = 2 if rows > 1 else 4
            heads, self_rows, cross_rows = (cfg.n_kv_heads, cap // parts,
                                            ENCDEC_FRAMES // parts)
        else:
            heads, self_rows, cross_rows = cfg.n_kv_heads // 2, cap, \
                ENCDEC_FRAMES
        assert shapes["self_k"] == [cfg.n_layers, b, self_rows, heads,
                                    cfg.dh]
        assert shapes["cross_v"] == [cfg.n_layers, b, cross_rows, heads,
                                     cfg.dh]


@pytest.mark.parametrize("window", MERGE_WINDOWS)
@pytest.mark.parametrize("axes", MERGE_AXES)
def test_merge_of_partials_matches_whole_cache(world, window, axes):
    """``decode_attention_part`` over each rank's range of a cache (1, 2 or
    4 uneven ranges: none, ``model``, ``data``, ``data`` x ``model``),
    merged across the ranks by ``TensorParallel.merge_attention``
    (log-sum-exp), equals ``decode_attention`` over the whole cache within
    1e-6 (f32) on every rank, sliding window or not; ranges with no visible
    row included (one range: the whole form merged alone)."""
    key = f"merge/{axes}/{window}"
    parts = 1 << len([a for a in axes.split(",") if a])
    ranges = set()
    for arrays, info in world["ranks"]:
        assert info[key]["parts"] == parts
        ranges.add(tuple(info[key]["range"]))
        got = arrays[key]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, arrays[key + "/whole"], rtol=0,
                                   atol=1e-6)
    assert len(ranges) == parts
