"""The PyTorch port's checkpointer, data pipeline and training launcher,
against the JAX package.

The reference's own checkpoint and data tests (tests/test_checkpoint_data.py)
are mirrored on the port; then each package restores what the other saved,
bit for bit, and the port's data is the reference's, token for token.
``repro_torch.launch.train`` resumes an interrupted run to the same losses
and writes the reference's event kinds and metric names.
"""
from __future__ import annotations

import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.checkpoint import ckpt as jckpt
from repro.configs.common import smoke_batch
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMPipeline as JPipeline
from repro.models import build as jbuild
from repro.optim import OptConfig as JOptConfig
from repro.training import init_train_state as jinit_train_state
from repro.training import make_train_step as jmake_train_step
from repro_torch import configs as tconfigs
from repro_torch import tree
from repro_torch.checkpoint import ckpt
from repro_torch.data.pipeline import DataConfig, SyntheticLMPipeline, \
    _philox_tokens
from repro_torch.launch import train as train_cli
from repro_torch.models import build_lm
from repro_torch.models import common as tcommon
from repro_torch.optim import OptConfig
from repro_torch.training import make_train_step


def _tree():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones((5,), dtype=torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    path = ckpt.save(str(tmp_path), 7, t)
    assert path.endswith("step_7")
    restored = ckpt.restore(str(tmp_path), 7, t)
    for a, b in zip(tree.leaves(t), tree.leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_latest_ignores_tmp(tmp_path):
    ckpt.save(str(tmp_path), 5, _tree())
    ckpt.save(str(tmp_path), 10, _tree())
    os.makedirs(tmp_path / "step_99.tmp")        # simulated crashed commit
    os.makedirs(tmp_path / "step_50")            # no manifest -> invalid
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_checkpoint_resave_same_step(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 3, t)
    t2 = tree.map_tree(
        lambda x: x + 1 if x.dtype == torch.float32 else x, t)
    ckpt.save(str(tmp_path), 3, t2)
    restored = ckpt.restore(str(tmp_path), 3, t)
    assert torch.equal(restored["params"]["w"], t2["params"]["w"])


def test_checkpoint_bf16_preserved(tmp_path):
    t = {"x": (torch.arange(64, dtype=torch.float32) * 0.1).bfloat16()}
    ckpt.save(str(tmp_path), 1, t)
    restored = ckpt.restore(str(tmp_path), 1, t)
    assert restored["x"].dtype == torch.bfloat16
    assert torch.equal(t["x"], restored["x"])


def test_checkpoint_layout_is_the_reference(tmp_path):
    """keystr leaf keys, ``key||0||0,0`` shard entries (``key||0||`` for a
    scalar), bf16 as uint16 bits, numpy dtype names."""
    ckpt.save(str(tmp_path), 2, _tree())
    step = tmp_path / "step_2"
    with open(step / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["n_hosts"] == 1 and manifest["step"] == 2
    assert manifest["leaves"] == {
        "['opt']['step']": {"shape": [], "dtype": "int32", "bf16": False},
        "['params']['b']": {"shape": [5], "dtype": "bfloat16", "bf16": True},
        "['params']['w']": {"shape": [3, 4], "dtype": "float32",
                            "bf16": False}}
    with np.load(step / "host_0.npz") as z:
        assert sorted(z.files) == ["['opt']['step']||0||",
                                   "['params']['b']||0||0",
                                   "['params']['w']||0||0,0"]
        assert z["['params']['b']||0||0"].dtype == np.uint16


def test_train_state_roundtrip(tmp_path):
    """Full train-state checkpoint -> restore -> training continues
    bit-identically (the fault-tolerance contract)."""
    from repro_torch.training import init_train_state

    bundle = build_lm(tconfigs.get("llama3.2-1b").SMOKE)
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=50)
    state = init_train_state(torch.Generator().manual_seed(0), bundle,
                             opt_cfg)
    step = make_train_step(bundle, opt_cfg)
    batch = t_batch(np_batch("llama3.2-1b"))
    state, _ = step(state, batch)

    ckpt.save(str(tmp_path), 1, state)
    restored = ckpt.restore(str(tmp_path), 1, state)
    s_a, m_a = step(state, batch)
    s_b, m_b = step(restored, batch)
    assert m_a["loss"].item() == m_b["loss"].item()
    for a, b in zip(tree.leaves(s_a["params"]), tree.leaves(s_b["params"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# async checkpointing


def test_async_save_returns_before_commit(tmp_path):
    """save() returns while the write is still in flight; wait() is the
    commit barrier."""
    gate = threading.Event()
    writer = ckpt.AsyncCheckpointer(str(tmp_path), _pre_commit=gate.wait)
    t = _tree()
    writer.save(4, t)                         # returns with commit gated
    assert not (tmp_path / "step_4").exists()
    assert ckpt.latest_step(str(tmp_path)) is None
    gate.set()
    path = writer.wait()
    assert path.endswith("step_4")
    assert (tmp_path / "step_4" / "manifest.json").exists()
    restored = ckpt.restore(str(tmp_path), 4, t)
    assert torch.equal(restored["params"]["w"], t["params"]["w"])


def test_async_save_snapshots_before_returning(tmp_path):
    """What is written is the tree as it was at save(), whatever the step
    loop does to its tensors afterwards."""
    gate = threading.Event()
    writer = ckpt.AsyncCheckpointer(str(tmp_path), _pre_commit=gate.wait)
    t = _tree()
    writer.save(1, t)
    t["params"]["w"].add_(100.0)
    gate.set()
    writer.wait()
    restored = ckpt.restore(str(tmp_path), 1, t)
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12, dtype=torch.float32).reshape(3, 4))


def test_async_second_save_is_barrier(tmp_path):
    """A second save() observes the first one committed (no two writes in
    flight), and the committed checkpoint restores."""
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    t = _tree()
    writer.save(1, t)
    writer.save(2, t)                         # waits for step 1 first
    assert (tmp_path / "step_1" / "manifest.json").exists()
    writer.wait()
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_async_save_error_surfaces_on_wait(tmp_path):
    def boom():
        raise RuntimeError("disk on fire")

    writer = ckpt.AsyncCheckpointer(str(tmp_path), _pre_commit=boom)
    writer.save(1, _tree())
    with pytest.raises(RuntimeError, match="disk on fire"):
        writer.wait()
    assert ckpt.latest_step(str(tmp_path)) is None


def test_keep_last_gc(tmp_path):
    writer = ckpt.AsyncCheckpointer(str(tmp_path), keep_last=2)
    t = _tree()
    for step in (1, 2, 3, 4):
        writer.save(step, t)
    writer.wait()
    assert ckpt.latest_step(str(tmp_path)) == 4
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_3", "step_4"]


def test_crashed_tmp_cleaned_on_next_save(tmp_path):
    """A stale step_*.tmp from a crashed run is swept by the next save,
    and latest_step never saw it."""
    stale = tmp_path / "step_9.tmp"
    os.makedirs(stale)
    (stale / "host_0.npz").write_bytes(b"partial garbage")
    assert ckpt.latest_step(str(tmp_path)) is None
    writer = ckpt.AsyncCheckpointer(str(tmp_path))
    writer.save(10, _tree())
    writer.wait()
    assert not stale.exists()
    assert ckpt.latest_step(str(tmp_path)) == 10


# ---------------------------------------------------------------------------
# each package restores what the other saved


def np_batch(arch):
    return jax.tree.map(np.asarray, smoke_batch(jconfigs.get(arch).SMOKE))


def t_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_run():
    """The reference's llama SMOKE train state after one step, and its
    next step's metrics and moments."""
    jbundle = jbuild(jconfigs.get("llama3.2-1b").SMOKE)
    opt_cfg = JOptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=50,
                         policy="fused")
    step = jax.jit(jmake_train_step(jbundle, opt_cfg))
    batch = np_batch("llama3.2-1b")
    state, _ = step(jinit_train_state(jax.random.PRNGKey(0), jbundle,
                                      opt_cfg), batch)
    nxt, metrics = step(state, batch)
    return dict(state=state, batch=batch, next=nxt, metrics=metrics)


def port_target():
    from repro_torch.training import init_train_state

    return init_train_state(torch.Generator().manual_seed(1),
                            build_lm(tconfigs.get("llama3.2-1b").SMOKE),
                            OptConfig())


def test_port_restores_the_reference_checkpoint(tmp_path, ref_run):
    """The reference saves a train state; the port restores it bit for bit
    (dtypes too), and the port's next step matches the reference's: the
    metrics and the momentum within rtol 1e-5, atol 1e-6."""
    jckpt.save(str(tmp_path), 1, ref_run["state"])
    state = ckpt.restore(str(tmp_path), 1, port_target())
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(ref_run["state"])}
    got = dict(tree.items(state))
    assert got.keys() == want.keys()
    for k, v in got.items():
        v = v if isinstance(v, np.ndarray) else v.numpy()
        assert v.dtype == want[k].dtype, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert isinstance(state["rng"], np.ndarray)

    bundle = build_lm(tconfigs.get("llama3.2-1b").SMOKE)
    opt_cfg = OptConfig(peak_lr=1e-3, warmup_steps=0, decay_steps=50)
    nxt, metrics = make_train_step(bundle, opt_cfg)(
        state, t_batch(ref_run["batch"]))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(metrics[k].item(),
                                   float(ref_run["metrics"][k]), rtol=1e-5)
    want_m = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
              jax.tree_util.tree_leaves_with_path(ref_run["next"]["opt"]["m"])}
    for k, v in tree.items(nxt["opt"]["m"]):
        np.testing.assert_allclose(v.numpy(), want_m[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert nxt["opt"]["step"].item() == 2


def test_reference_restores_the_port_checkpoint(tmp_path, ref_run):
    """The port saves (a train state, and a tree with a bf16 leaf); the
    reference's ``ckpt.restore`` reads both back bit for bit."""
    jstate = ref_run["state"]
    np_state = jax.tree.map(np.asarray, jstate)
    rng = np_state.pop("rng")
    port_state = tcommon.tree_from_numpy(np_state, device="cpu")
    port_state["rng"] = rng
    ckpt.save(str(tmp_path), 3, port_state)
    back = jckpt.restore(str(tmp_path), 3, jstate)
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    ckpt.save(str(tmp_path / "small"), 1, _tree())
    jtree = {"params": {"w": jnp.zeros((3, 4), jnp.float32),
                        "b": jnp.zeros((5,), jnp.bfloat16)},
             "opt": {"step": jnp.int32(0)}}
    back = jckpt.restore(str(tmp_path / "small"), 1, jtree)
    assert back["params"]["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back["params"]["b"],
                                             np.float32), np.ones(5))
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  np.arange(12.0).reshape(3, 4))
    assert int(back["opt"]["step"]) == 7


# ---------------------------------------------------------------------------
# data pipeline


@pytest.mark.parametrize("split", [(0, 1), (0, 3), (1, 3), (2, 3), (3, 4),
                                   (1, 5)])
def test_data_matches_the_reference(split):
    """Tokens and labels equal the reference's, bit for bit, steps 0-3, for
    each (process_index, process_count) split of a batch of 10."""
    kw = dict(vocab=50280, seq_len=24, global_batch=10, seed=5)
    port = SyntheticLMPipeline(DataConfig(**kw), device="cpu")
    ref = JPipeline(JDataConfig(**kw))
    rng = port.host_range(*split)
    assert rng == ref.host_range(*split)
    for step in range(4):
        got = _philox_tokens(port.cfg, step, *rng)
        want = jax_philox(ref.cfg, step, *rng)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if split == (0, 1):
        for step in range(4):
            hb, jb = port.host_batch(step), ref.host_batch(step)
            db = port.device_batch(step)
            for k in ("tokens", "labels"):
                np.testing.assert_array_equal(hb[k], jb[k])
                np.testing.assert_array_equal(db[k].numpy(), jb[k])
                assert db[k].dtype == torch.int32


def jax_philox(cfg, step, lo, hi):
    from repro.data.pipeline import _philox_tokens as ref_tokens

    return ref_tokens(cfg, step, lo, hi)


def test_data_deterministic_across_instances():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=3)
    a = SyntheticLMPipeline(cfg, device="cpu").host_batch(5)
    b = SyntheticLMPipeline(cfg, device="cpu").host_batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_data_step_variation():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8)
    p = SyntheticLMPipeline(cfg, device="cpu")
    assert not np.array_equal(p.host_batch(0)["tokens"],
                              p.host_batch(1)["tokens"])


def test_data_labels_are_shifted_tokens():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=4)
    hb = SyntheticLMPipeline(cfg, device="cpu").host_batch(0)
    full = _philox_tokens(cfg, 0, 0, 4)
    np.testing.assert_array_equal(hb["tokens"], full[:, :-1])
    np.testing.assert_array_equal(hb["labels"], full[:, 1:])


def test_data_host_shards_disjoint_and_stable():
    """A replacement host regenerates exactly its shard (no drift)."""
    cfg = DataConfig(vocab=500, seq_len=8, global_batch=16, seed=9)
    full = _philox_tokens(cfg, 3, 0, 16)
    lo_hi = [(0, 4), (4, 8), (8, 12), (12, 16)]
    shards = [_philox_tokens(cfg, 3, lo, hi) for lo, hi in lo_hi]
    np.testing.assert_array_equal(np.concatenate(shards), full)


def test_data_host_range_remainder():
    """global_batch=10 over 4 hosts -> sizes [3, 3, 2, 2], slices disjoint
    and exactly covering [0, 10)."""
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=10)
    p = SyntheticLMPipeline(cfg, device="cpu")
    ranges = [p.host_range(process_index=i, process_count=4)
              for i in range(4)]
    assert [hi - lo for lo, hi in ranges] == [3, 3, 2, 2]
    covered = [i for lo, hi in ranges for i in range(lo, hi)]
    assert covered == list(range(10))


def test_data_host_range_divisible_matches_even_split():
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=16)
    p = SyntheticLMPipeline(cfg, device="cpu")
    assert [p.host_range(process_index=i, process_count=4)
            for i in range(4)] == [(0, 4), (4, 8), (8, 12), (12, 16)]
    assert p.host_range() == (0, 16)    # no torch.distributed: one process


def test_data_simulated_hosts_cover_global_batch():
    """Shards drawn per simulated host concatenate to the full batch even
    with a remainder (the multi-host data contract)."""
    cfg = DataConfig(vocab=500, seq_len=8, global_batch=10, seed=2)
    p = SyntheticLMPipeline(cfg, device="cpu")
    full = _philox_tokens(cfg, 4, 0, cfg.global_batch)
    shards = [_philox_tokens(cfg, 4, *p.host_range(process_index=i,
                                                   process_count=3))
              for i in range(3)]
    np.testing.assert_array_equal(np.concatenate(shards), full)


def test_data_skip_to_resume():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=4)
    p = SyntheticLMPipeline(cfg, device="cpu")
    p.skip_to(7)
    it = iter(p)
    try:
        s, batch = next(it)
        assert s == 7
        np.testing.assert_array_equal(
            batch["tokens"].numpy(),
            SyntheticLMPipeline(cfg, device="cpu").host_batch(7)["tokens"])
        s, _ = next(it)
        assert s == 8
        with pytest.raises(RuntimeError, match="before iteration"):
            p.skip_to(3)
    finally:
        p.close()
    assert not p._thread.is_alive()


# ---------------------------------------------------------------------------
# the launcher


CLI = ["--config", "smoke", "--device", "cpu", "--batch", "2", "--seq",
       "16", "--warmup-steps", "2", "--decay-steps", "6", "--log-every",
       "100"]


def events(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def metric_names(path) -> set[str]:
    with open(path) as f:
        return {line.split()[2] for line in f if line.startswith("# TYPE")}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-1.3b"])
def test_cli_resume_continues_the_interrupted_run(tmp_path, arch):
    """4 steps with a checkpoint every 2, then ``--steps 6 --resume auto``:
    the second run resumes at step 4 and its losses equal those of one
    uninterrupted 6-step run (the schedule fixed by --warmup-steps and
    --decay-steps, which the reference derives from --steps)."""
    cli = CLI + ["--arch", arch]
    whole = train_cli.main(cli + ["--steps", "6", "--ckpt-dir",
                                  str(tmp_path / "a"), "--ckpt-every", "2"])
    first = train_cli.main(cli + ["--steps", "4", "--ckpt-dir",
                                  str(tmp_path / "b"), "--ckpt-every", "2"])
    assert ckpt.latest_step(str(tmp_path / "b")) == 4
    resumed = train_cli.main(cli + ["--steps", "6", "--ckpt-dir",
                                    str(tmp_path / "b"), "--resume", "auto"])
    assert sorted(resumed) == [4, 5]
    assert {**first, **resumed} == whole


def test_cli_writes_the_reference_events_and_metrics(tmp_path, monkeypatch):
    """``--obs-events`` and ``--metrics-out``: the port's run writes the
    event kinds and metric names of the reference's run (the reference's
    launcher, same flags, in this process); train_step events carry the
    step and loss, the checkpoint its three phases."""
    from repro.launch import train as jtrain

    flags = ["--steps", "3", "--batch", "2", "--seq", "16", "--ckpt-every",
             "2", "--log-every", "100"]
    ref = tmp_path / "ref"
    monkeypatch.setattr(sys, "argv", ["train"] + flags + [
        "--ckpt-dir", str(ref / "ck"), "--obs-events", str(ref / "e.jsonl"),
        "--metrics-out", str(ref / "m.prom")])
    ref.mkdir()
    jtrain.main()
    port = tmp_path / "port"
    port.mkdir()
    # under tile (each kernel's plain version on the CPU): the port's CPU
    # auto runs torch forms, no kernel wrapper, where the reference's
    # registry still records its fused RMSNorm as an invocation
    losses = train_cli.main(flags + [
        "--config", "smoke", "--device", "cpu", "--policy", "tile",
        "--ckpt-dir",
        str(port / "ck"), "--obs-events", str(port / "e.jsonl"),
        "--metrics-out", str(port / "m.prom")])

    got, want = events(port / "e.jsonl"), events(ref / "e.jsonl")
    # the same kinds; the reference records resolution and kernel_invoke
    # once per jit trace, the port, eager, at every call
    assert {e["kind"] for e in got} == {e["kind"] for e in want} == {
        "train_step_trace", "train_step", "ckpt", "resolution",
        "kernel_invoke"}
    assert [e["step"] for e in got if e["kind"] == "train_step"] == [0, 1, 2]
    assert [e["loss"] for e in got if e["kind"] == "train_step"] == [
        losses[s] for s in range(3)]
    assert sum(e["kind"] == "train_step_trace" for e in got) == 1
    phases = [e["phase"] for e in got if e["kind"] == "ckpt"]
    assert phases.count("snapshot") == 2 and phases.count("write") == 2
    assert "commit_barrier" in phases
    assert metric_names(port / "m.prom") == metric_names(ref / "m.prom")
    for name in ("repro_train_step_traces_total", "repro_train_step_seconds",
                 "repro_train_tokens_per_s", "repro_ckpt_snapshot_seconds",
                 "repro_ckpt_write_seconds",
                 "repro_ckpt_commit_barrier_seconds"):
        assert name in metric_names(port / "m.prom")
