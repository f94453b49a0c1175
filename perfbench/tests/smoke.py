"""Runs of the benchmark's cells on the CPU at the program's SMOKE sizes,
for the tests: the same runners, traffic generator, reference and checks
as on the card, with the sizes, slots and lengths cut down."""
from __future__ import annotations

import time

from perfbench.lib import manifest

CHAT, TRAIN = "mamba2-1.3b.chat", "mamba2-1.3b.train"


# the serving tests' sizes: as deep as SMOKE, but as wide as a real model's
# residual (logits spread as at full width, so a wrong token reads as far
# below the best as it does there)
WIDE = {"n_layers": 2, "d_model": 1024, "vocab": 4096, "ssm_state": 16,
        "ssm_head_dim": 64}


def smoke_config(name: str, wide: bool = False):
    """(the configuration file with the program's SMOKE sizes, or with
    ``WIDE``'s, and the program's ModelConfig of those sizes)."""
    import dataclasses

    from repro_torch import configs
    cfg = dict(manifest.config(name))
    sm = configs.get(cfg["arch"]).SMOKE
    if wide:
        sm = dataclasses.replace(sm, **WIDE)
    keys = ["n_layers", "d_model", "vocab", "ssm_state", "ssm_head_dim",
            "ssm_groups", "expand", "conv_kernel", "norm_eps"]
    cfg.update({k: getattr(sm, k) for k in keys})
    return cfg, sm


def make(cell: str, seed: int = 12345, seconds: float = 4.0,
         trace: bool = False, **kw):
    """A CPU run of ``cell`` at SMOKE size (``kw`` go to the Run)."""
    from perfbench import run as bench_run
    bench = manifest.benchmark()
    r = bench_run.make_run(bench, cell, seed, seconds, trace, "cpu",
                           time.perf_counter(), **kw)
    r.config, r.model_cfg = smoke_config(r.workload["config"],
                                         wide=cell != TRAIN)
    if cell == CHAT:
        r.cell = dict(r.cell, slots=4, prefill_chunk=4, rate_rps=1.5,
                      sample_tokens=40)
        r.mix = dict(r.mix, lead_in_s=0.5,
                     prompt=dict(median=12, sigma=0.8, min=4, max=32),
                     output=dict(median=6, sigma=0.6, min=2, max=16))
    else:
        r.mix = dict(r.mix, seq_len=32)
    return bench, r


def perform(cell: str, **kw) -> dict:
    from perfbench import run as bench_run
    bench, r = make(cell, **kw)
    return bench_run.perform(r, bench)
