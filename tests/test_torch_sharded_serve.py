"""Sharded lockstep serving of the port (``ServingEngine(mesh_ctx=...)``,
the head-split block steps of ``models/layers.py``) and the two
launchers under ``torch.distributed.run``, against the JAX package's
engine on the CPU.

One module-scoped fixture carries the reference's llama3.2-1b SMOKE params
(f32, ``init_params(PRNGKey(0))``) into numpy and starts a gloo world of 2
processes (a ``file://`` init in a temporary directory) that serves the
reference multi-host e2e's requests (tests/test_multihost.py: 2 slots,
``max_new=4``, ``prefill_chunk=4``, 3 prompts of 6 tokens, seed 0) on a
``model=2`` mesh, on the ring and on the paged cache, beside the port's
unsharded engine in the same process, and mamba2's SMOKE engine on the
mesh beside its unsharded one; the reference's unsharded engine serves
them here. Each test then reads one result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.models import build as jbuild
from repro.models.common import init_params as jinit_params
from repro.serving import Request as JRequest
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300          # seconds, the world and each launcher run
ARCH = "llama3.2-1b"
SERVE = dict(slots=2, max_new=4, eos_token=-1, prefill_chunk=4)


def _prompts(vocab: int) -> list:
    rng = np.random.default_rng(0)
    return [rng.integers(3, vocab, size=6, dtype=np.int32) for _ in range(3)]


WORKER = """
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + os.path.join(
    d, "init"), rank=rank, world_size=world)
from repro_torch import configs, tree
from repro_torch.models import build
from repro_torch.models.common import params_from_numpy, partition_specs
from repro_torch.parallel import make_context
from repro_torch.parallel.sharded_state import place_tree
from repro_torch.parallel.sharding import is_dtensor
from repro_torch.serving import Request, ServeConfig, ServingEngine

serve = json.loads(sys.argv[4])
cfg = configs.get("llama3.2-1b").SMOKE
bundle = build(cfg)
z = np.load(os.path.join(d, "params.npz"))
flat = {}
for k in z.files:           # "a/b/c" -> nested dicts, the stacked layout
    node = flat
    *head, last = k.split("/")
    for h in head:
        node = node.setdefault(h, {})
    node[last] = z[k]
params = params_from_numpy(flat, cfg, device="cpu")
rng = np.random.default_rng(0)
prompts = [rng.integers(3, cfg.vocab, size=6, dtype=np.int32)
           for _ in range(3)]
ctx = make_context("model=2", device="cpu")
specs = partition_specs(bundle.params_pspec, rules=ctx.rules, fsdp_ok=False)
placed = place_tree(params, tree.map_tree(
    lambda _, s: ctx.named_sharding(s), bundle.params_pspec, specs))
out, info = {}, {}


def serve_with(kind, mesh):
    eng = ServingEngine(bundle, placed if mesh else params,
                        ServeConfig(cache_kind=kind, **serve),
                        mesh_ctx=ctx if mesh else None)
    seen = []
    sample = eng._sample

    def keep(logits):
        seen.append(logits.float().numpy().copy())
        return sample(logits)

    eng._sample = keep
    res = eng.run([Request(uid=i, prompt=p) for i, p in enumerate(prompts)])
    return eng, {r.uid: [int(t) for t in r.tokens] for r in res}, seen


for kind in ("ring", "paged"):
    eng, toks, logits = serve_with(kind, True)
    info[kind] = {"tokens": toks, "trace": eng.trace,
                  "stats": eng.compile_stats(),
                  "kv_heads": int(eng._cache["attn"]["k"].shape[-2]),
                  "wq_cols": int(eng.params["blocks"][0]["attn"]["wq"]
                                 .shape[-1])}
    _, utoks, ulogits = serve_with(kind, False)
    info[kind]["unsharded_tokens"] = utoks
    out[kind] = np.stack(logits)
    out[kind + "_unsharded"] = np.stack(ulogits)
info["placed_dtensor"] = all(is_dtensor(t) for t in tree.leaves(placed))
try:
    ServingEngine(bundle, placed, ServeConfig(scheduler="wave", **serve),
                  mesh_ctx=ctx)
except ValueError as e:
    info["wave_raises"] = str(e)
# mamba2 and qwen3-moe serve on the mesh: the SSM heads, the experts split
# over model
from repro_torch.models.common import init_params
for arch in ("mamba2-1.3b", "qwen3-moe-235b-a22b"):
    mcfg = configs.get(arch).SMOKE
    mb = build(mcfg)
    mp = init_params(mb.params_pspec, torch.Generator().manual_seed(0),
                     mcfg.dtype)
    info[arch + "_tokens"] = [
        {r.uid: [int(t) for t in r.tokens] for r in ServingEngine(
            mb, mp, ServeConfig(**serve), mesh_ctx=c).run(
                [Request(uid=i, prompt=p) for i, p in enumerate(prompts)])}
        for c in (ctx, None)]

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


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_serve")
    cfg = jconfigs.get(ARCH).SMOKE
    bundle = jbuild(cfg)
    params = jinit_params(jax.random.PRNGKey(0), bundle.params_pspec,
                          cfg.dtype)
    np.savez(d / "params.npz", **{
        "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(params)})
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(WORKER), str(r), "2", str(d),
         json.dumps(SERVE)], cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
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
    ref = {}
    for kind in ("ring", "paged"):
        eng = JServingEngine(bundle, params, JServeConfig(
            scheduler="continuous", cache_kind=kind, **SERVE))
        res = eng.run([JRequest(uid=i, prompt=p)
                       for i, p in enumerate(_prompts(cfg.vocab))])
        ref[kind] = {str(r.uid): [int(t) for t in r.tokens] for r in res}
    return {"ranks": [(dict(np.load(d / f"r{r}.npz")),
                       json.loads((d / f"r{r}.json").read_text()))
                      for r in range(2)], "ref": ref}


@pytest.mark.parametrize("kind", ("ring", "paged"))
def test_lockstep_tokens_match_unsharded_engines(world, kind):
    """Both ranks emit the same tokens, equal to the port's unsharded
    engine's and to the reference's unsharded engine's (greedy, f32); the
    admit/finish trace is the same on both ranks."""
    (_, i0), (_, i1) = world["ranks"]
    assert i0[kind]["tokens"] == i1[kind]["tokens"]
    assert i0[kind]["trace"] == i1[kind]["trace"]
    assert i0[kind]["tokens"] == i0[kind]["unsharded_tokens"]
    assert i0[kind]["tokens"] == world["ref"][kind]
    assert all(len(t) == 4 for t in i0[kind]["tokens"].values())


@pytest.mark.parametrize("kind", ("ring", "paged"))
def test_sharded_logits_match_unsharded(world, kind):
    """Every tick's logits within 1e-5 of the unsharded port's, and equal on
    both ranks (replicated before sampling)."""
    (a0, _), (a1, _) = world["ranks"]
    np.testing.assert_array_equal(a0[kind], a1[kind])
    np.testing.assert_allclose(a0[kind], a0[kind + "_unsharded"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ("ring", "paged"))
def test_each_rank_holds_its_kv_heads_and_runs_eager(world, kind):
    """The cache holds one of SMOKE's 2 KV heads a rank, wq that head
    group's 2 of 4 query heads (16 columns each); no graph is captured
    under the multi-rank mesh and ``compile_stats`` says why."""
    for _, info in world["ranks"]:
        assert info["placed_dtensor"]
        assert info[kind]["kv_heads"] == 1
        assert info[kind]["wq_cols"] == 2 * 16
        stats = info[kind]["stats"]
        assert stats["graphs"] == 0 and "eager" in stats
        assert stats["block"] >= 1


def test_wave_and_unported_families_raise_under_mesh(world):
    """The wave scheduler raises under the mesh; mamba2 (its SSM heads
    split over ``model``) and qwen3-moe (its experts split over ``model``)
    serve the tokens of the unsharded engine."""
    for _, info in world["ranks"]:
        assert "continuous scheduler" in info["wave_raises"]
        for arch in ("mamba2-1.3b", "qwen3-moe-235b-a22b"):
            sharded, unsharded = info[arch + "_tokens"]
            assert sharded == unsharded and len(sharded) == 3, arch


def _torchrun(args: list, tmp: Path) -> str:
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *args], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_launchers_train_then_serve_sharded(tmp_path):
    """``launch.train --mesh data=2`` under torchrun, then ``launch.serve
    --mesh model=2 --ckpt-dir`` on its checkpoint."""
    ck = str(tmp_path / "ck")
    out = _torchrun(["-m", "repro_torch.launch.train", "--device", "cpu",
                     "--mesh", "data=2", "--steps", "2", "--log-every", "1",
                     "--ckpt-dir", ck], tmp_path)
    assert "training sharded over mesh data=2" in out
    assert out.count("step ") >= 2 and "checkpointed" in out
    assert sorted(os.listdir(os.path.join(ck, "step_2"))) == [
        "host_0.npz", "host_1.npz", "manifest.json"]
    out = _torchrun(["-m", "repro_torch.launch.serve", "--arch", ARCH,
                     "--config", "smoke", "--device", "cpu", "--mesh",
                     "model=2", "--ckpt-dir", ck, "--requests", "3",
                     "--max-new", "4"], tmp_path)
    assert "serving sharded over mesh model=2" in out
    assert "loaded checkpoint step 2" in out
    assert "3 requests, " in out
