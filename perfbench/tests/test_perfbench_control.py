"""The control at each cell's own size, on the card: the plain reference
one precision below the configuration's (float8 products for bfloat16) in
the program's place must come out not correct. A model of 48 layers is
what makes float8's error grow past the limit, so this runs at full size
and skips without a card; ``perfbench/control.py`` reads it on more
seeds. Run on the card: ``python3 -m pytest -q -m cuda perfbench``."""
import time

import pytest
import torch

from perfbench import run as bench_run
from perfbench.lib import manifest
from perfbench.runners import train

SERVE_CELLS = ("mamba2-1.3b.chat",)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_the_serving_control_fails_the_limit(card, cell):
    bench = manifest.benchmark()
    r = bench_run.make_run(bench, cell, 97, 10.0, False, card,
                           time.perf_counter(), control="fp8")
    line = bench_run.perform(r, bench)
    assert line["correct"], line["checks"]
    assert line["notes"]["control_gap"] > \
        line["checks"]["max_logit_gap"]["limit"]


@pytest.mark.cuda
def test_the_training_control_fails_a_limit(card):
    bench = manifest.benchmark()
    r = bench_run.make_run(bench, "mamba2-1.3b.train", 97, 10.0, False,
                           card, time.perf_counter())
    sound = train.reference_steps(r, r.config, r.cell, keep_first=True)
    low = train.reference_steps(r, r.config, r.cell, quant="fp8",
                                first=sound["first"])
    got = train.compare(low["loss"], low["grad"], low["change"], sound,
                        low["direction"])
    lim = r.cell["limits"]
    assert any(got[k] > lim[k] for k in train.COMPARED), got
