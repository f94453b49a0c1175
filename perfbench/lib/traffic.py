"""The one traffic generator: a mix file of parameters -> requests.

A mix (``traffic/<name>.json``) gives the distributions of prompt and
output lengths and how requests arrive; the cell (``cells/<name>.json``)
gives the rate and the slots. Every seed gets the same set of lengths and
of gaps between arrivals: they are the distributions' quantiles at
``(i + 0.5) / n``, in an order shuffled once, the same for every seed: a
backlog's window serves only its first requests, and a tail over a few
dozen arrivals moves with their order, so an order of the seed's would
change the work (a first set of runs of an offline backlog, its order the
seed's, read 12% apart across seeds and 0.5% apart on one seed). The seed
draws the prompts' token ids, and the weights.

Arrivals:

* ``poisson``: an open loop. ``lead_in_s`` seconds of arrivals at the
  cell's ``rate_rps`` load the slots before the measured window; then the
  window's ``rate_rps * seconds`` arrivals. Each set's gaps are exponential
  quantiles, shuffled.
* ``backlog``: an offline batch, ``backlog_per_slot * slots`` requests all
  due at t = 0, more than a window can finish.
"""
from __future__ import annotations

import dataclasses
import math
import statistics

import numpy as np

from perfbench.lib import frozen

_NORMAL = statistics.NormalDist()


@dataclasses.dataclass
class Req:
    uid: int
    prompt: np.ndarray
    max_new: int
    arrival_s: float
    in_window: bool


def lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of a lognormal of
    ``median`` and ``sigma``, clipped to [``min``, ``max``], ascending."""
    q = [(i + 0.5) / n for i in range(n)]
    raw = [spec["median"] * math.exp(spec["sigma"] * _NORMAL.inv_cdf(p))
           for p in q]
    return np.clip(np.rint(raw), spec["min"], spec["max"]).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """``n`` gaps at the quantiles ``(i + 0.5) / n`` of an exponential of
    mean ``1 / rate``."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) / rate


def _draw(mix: dict, n: int, rng: np.random.Generator):
    """(prompt lengths, output budgets) of ``n`` requests, each set in
    ``rng``'s order."""
    return (rng.permutation(lengths(mix["prompt"], n)),
            rng.permutation(lengths(mix["output"], n)))


def make_requests(mix: dict, cell: dict, *, seconds: float, seed: int,
                  vocab: int) -> list[Req]:
    """The requests of one run, sorted by arrival."""
    rng = np.random.default_rng([0, 0])        # the order: one for all
    tok_rng = np.random.default_rng([seed, 1])
    out: list[Req] = []

    def add(plens, budgets, arrivals, in_window):
        for plen, budget, t in zip(plens, budgets, arrivals):
            out.append(Req(len(out), frozen.prompt_tokens(tok_rng, int(plen),
                                                          vocab),
                           int(budget), float(t), in_window))

    if mix["arrivals"] == "poisson":
        rate = float(cell["rate_rps"])
        start = 0.0
        for span, in_window in ((mix.get("lead_in_s", 0.0), False),
                                (seconds, True)):
            n = int(round(rate * span))
            if n == 0:
                continue
            gaps = rng.permutation(exp_gaps(rate, n))
            arrivals = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
            add(*_draw(mix, n, rng), arrivals, in_window)
            start += span
    elif mix["arrivals"] == "backlog":
        n = int(mix["backlog_per_slot"]) * int(cell["slots"])
        add(*_draw(mix, n, rng), np.zeros(n), True)
    else:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
    return out


def window_start(mix: dict) -> float:
    """Seconds from the traffic's start to the measured window's."""
    return float(mix.get("lead_in_s", 0.0)) if mix["arrivals"] == "poisson" \
        else 0.0


def capacity_need(requests: list[Req]) -> int:
    """The most cache rows one of ``requests`` needs (prompt and budget):
    the warm-up request's size, so that it captures the step graphs of the
    capacity bucket the run uses."""
    return max(len(r.prompt) + r.max_new for r in requests)
