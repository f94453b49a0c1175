"""The serving cell end to end on the CPU at the tests' size (SMOKE's
depth, a real residual width): the port's engine against the plain
reference, and ``correct`` false with the timed path broken underneath."""
import dataclasses
import types

import numpy as np
import pytest

from perfbench.tests import smoke

CELLS = (smoke.CHAT,)


@pytest.mark.parametrize("cell", CELLS)
def test_the_engine_agrees_with_the_reference(cell):
    line = smoke.perform(cell, seed=2 ** 31 + 17)
    assert line["correct"], line["checks"]
    assert line["checks"]["max_logit_gap"]["value"] < 1e-4
    assert line["attempted"] > 0 and line["failed"] == 0
    assert line["notes"]["sampled_tokens"] > 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_host_metrics(cell):
    line = smoke.perform(cell, seed=9, trace=True)
    assert line["correct"], line["checks"]
    names = set(line["metrics"])
    suffix = cell.split(".")[-1]
    assert {f"valid_row_share.{suffix}", f"mfu.{suffix}",
            f"sched_host_ms.{suffix}"} <= names


def _alter_tokens(engine):
    sample = engine._sample
    vocab = engine.bundle.cfg.vocab

    def altered(logits):
        out = sample(logits)
        return np.where(out >= 0, (out + 1) % vocab, out)

    engine._sample = altered


def _state_unchanged(engine):
    step = engine.bundle.decode_block

    def stale(params, cache, batch, **kw):
        copy = {k: ({kk: vv.clone() for kk, vv in v.items()}
                    if isinstance(v, dict) else v.clone())
                for k, v in cache.items()}
        logits, _ = step(params, copy, batch, **kw)
        return logits, cache

    engine.bundle = dataclasses.replace(engine.bundle, decode_block=stale)


def _half_the_slots(engine):
    step = engine._block_step

    def half(inputs):
        n_valid = np.array(inputs["n_valid"])
        n_valid[:len(n_valid) // 2] = 0
        return step(dict(inputs, n_valid=n_valid))

    engine._block_step = half


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_the_slots],
                         ids=["token_altered", "state_unchanged",
                              "half_the_slots"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    line = smoke.perform(cell, seed=31, fault=fault)
    assert not line["correct"], line["checks"]


def test_the_program_runs_the_file_s_sizes():
    from repro_torch import models

    from perfbench.lib import manifest
    from perfbench.runners import serve
    r = types.SimpleNamespace(model_cfg=None)
    cfg = manifest.config("mamba2-1.3b")
    mcfg = serve.program_config(r, cfg)
    assert mcfg.tie_embeddings and mcfg.vocab == 50288
    assert "head" not in models.build(mcfg).params_pspec
    with pytest.raises(ValueError):
        serve.program_config(r, dict(cfg, d_model=1024))
