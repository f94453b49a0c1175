"""The traffic generator and the token feed: deterministic in the seed,
inside their declared bounds, the same work for every seed."""
import numpy as np
import pytest
import torch

from perfbench.lib import frozen, manifest, traffic
from perfbench.runners import train

BIG_SEED = 2 ** 31 + 12345
# an offline backlog beside the chat mix: the generator's other arrival kind
BACKLOG = {"arrivals": "backlog", "backlog_per_slot": 4, "end": "window",
           "prompt": {"median": 256, "sigma": 0.5, "min": 32, "max": 1024},
           "output": {"median": 1024, "sigma": 0.5, "min": 256, "max": 3072}}
MIXES = {"chat": (manifest.traffic("chat"),
                  manifest.cell("mamba2-1.3b.chat")),
         "backlog": (BACKLOG, {"slots": 32})}


def _reqs(mix_name: str, seed: int, seconds: float = 20.0):
    mix, cell = MIXES[mix_name]
    return traffic.make_requests(mix, cell, seconds=seconds, seed=seed,
                                 vocab=50288)


@pytest.mark.parametrize("mix_name", sorted(MIXES))
def test_same_seed_same_requests(mix_name):
    a, b = _reqs(mix_name, BIG_SEED), _reqs(mix_name, BIG_SEED)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.uid, x.max_new, x.arrival_s, x.in_window) == \
            (y.uid, y.max_new, y.arrival_s, y.in_window)
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("mix_name", sorted(MIXES))
def test_every_seed_gets_the_same_work_and_ids_of_its_own(mix_name):
    a, b = _reqs(mix_name, 1), _reqs(mix_name, 2)
    assert [(len(q.prompt), q.max_new, q.arrival_s) for q in a] == \
        [(len(q.prompt), q.max_new, q.arrival_s) for q in b]
    assert not np.array_equal(a[0].prompt, b[0].prompt)
    assert len({len(q.prompt) for q in a}) > 1


@pytest.mark.parametrize("mix_name", sorted(MIXES))
def test_lengths_and_ids_hold_their_bounds(mix_name):
    mix = MIXES[mix_name][0]
    for q in _reqs(mix_name, 7):
        assert mix["prompt"]["min"] <= len(q.prompt) <= mix["prompt"]["max"]
        assert mix["output"]["min"] <= q.max_new <= mix["output"]["max"]
        assert q.prompt.min() >= 3 and q.prompt.max() < 50288


def test_lengths_are_the_distribution_s_quantiles():
    spec = {"median": 512, "sigma": 0.8, "min": 32, "max": 2048}
    got = traffic.lengths(spec, 101)
    assert got[50] == 512 and np.all(np.diff(got) >= 0)
    assert got[0] >= 32 and got[-1] == 2048


def test_poisson_arrivals_fill_the_lead_in_and_the_window():
    mix, cell = manifest.traffic("chat"), dict(MIXES["chat"][1],
                                                rate_rps=2.0)
    reqs = traffic.make_requests(mix, cell, seconds=30.0, seed=3, vocab=100)
    lead = [q for q in reqs if not q.in_window]
    win = [q for q in reqs if q.in_window]
    assert len(lead) == round(2.0 * mix["lead_in_s"])
    assert len(win) == 60
    assert max(q.arrival_s for q in lead) < mix["lead_in_s"]
    assert min(q.arrival_s for q in win) == mix["lead_in_s"]
    assert max(q.arrival_s for q in win) < mix["lead_in_s"] + 30.0
    gaps = np.diff([q.arrival_s for q in win])
    assert np.all(gaps > 0)
    assert abs(np.mean(gaps) - 0.5) < 0.1


def test_backlog_is_due_at_once():
    reqs = _reqs("backlog", 11)
    assert len(reqs) == BACKLOG["backlog_per_slot"] * 32
    assert all(q.arrival_s == 0.0 and q.in_window for q in reqs)
    assert traffic.window_start(BACKLOG) == 0.0


def test_capacity_need_is_the_largest_request():
    reqs = _reqs("chat", 5)
    assert traffic.capacity_need(reqs) == max(len(q.prompt) + q.max_new
                                              for q in reqs)


def test_philox_batches_are_a_function_of_seed_and_step():
    a = frozen.philox_tokens(BIG_SEED, 3, 2, 16, 1000)
    assert np.array_equal(a, frozen.philox_tokens(BIG_SEED, 3, 2, 16, 1000))
    assert not np.array_equal(a, frozen.philox_tokens(BIG_SEED, 4, 2, 16,
                                                      1000))
    assert a.shape == (2, 17) and a.min() >= 1 and a.max() < 1000


def test_feed_gives_the_pure_batches_and_stops():
    feed = train.Feed(9, 2, 8, 500, torch.device("cpu"))
    try:
        for step in range(3):
            got = feed.next()
            want = train.batch_tokens(9, step, 2, 8, 500)
            assert torch.equal(got["tokens"], torch.from_numpy(want[:, :-1]))
            assert torch.equal(got["labels"], torch.from_numpy(want[:, 1:]))
    finally:
        feed.close()
    assert not feed.thread.is_alive()
