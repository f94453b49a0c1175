"""``mfu.<cell>``: the whole step's share of the card's bf16 peak, in
percent: model FLOPs (``configs/<costs>.py``: the weights' products and
the SSM's recurrent work) over the
step's wall seconds x 989e12. It counts the work the model needs, not how
the kernels do it, so a kernel taken off the path leaves it comparable.

Serving: each tick's valid token rows only, the head once for each slot
with a valid row; over the window's ticks outside the
profiled slice, each from its step's call to its tokens' return. Training:
the FLOPs of each step (forward and backward) over the window's steps
outside the profiled slice.
"""
import math

from perfbench.lib import frozen


def _serve(rec, costs):
    cfg = rec.config
    flops = seconds = 0.0
    for t in rec.window_ticks(unprofiled=True):
        rows = int(t.n_valid.sum())
        flops += rows * costs.mamba_flops_token(cfg) \
            + int((t.n_valid > 0).sum()) * costs.head_flops(cfg)
        seconds += t.end - t.start
    return flops, seconds


def read(name, rec):
    costs = rec.costs()
    if rec.steps:
        steps = [s for s in rec.steps if s.in_window and not s.profiled]
        per = costs.train_flops(rec.config, rec.cell["batch"],
                                steps[0].tokens // rec.cell["batch"]) \
            if steps else 0
        flops = per * len(steps)
        seconds = sum(s.end - s.start for s in steps)
    else:
        flops, seconds = _serve(rec, costs)
    if not seconds or not flops or not math.isfinite(flops):
        return None
    return 100.0 * flops / (seconds * frozen.PEAK_FLOPS_BF16)
