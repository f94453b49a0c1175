"""The training cell end to end on the CPU at SMOKE size: the port's train
step against the plain reference's three steps, and ``correct`` false with
the step broken underneath."""
import pytest

from perfbench.tests import smoke


def test_the_train_step_agrees_with_the_reference():
    line = smoke.perform(smoke.TRAIN, seed=2 ** 31 + 29)
    assert line["correct"], line["checks"]
    for name in ("grad_gap", "change_gap", "grad_dir_gap"):
        assert line["checks"][name]["value"] < 1e-5, name
    assert line["notes"]["loss_gap"] < 1e-5
    assert line["notes"]["window_steps"] >= 1
    assert list(line)[-1] == "checks"


def test_a_traced_run_reads_the_step_s_share_of_the_peak():
    line = smoke.perform(smoke.TRAIN, seed=3, trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["mfu.train"]["value"] > 0


def _unchanged(step):
    def stale(state, batch):
        _, metrics = step(state, batch)
        return state, metrics
    return stale


def _half_batch(step):
    def half(state, batch):
        rows = next(iter(batch.values())).shape[0] // 2
        return step(state, {k: v[:rows] for k, v in batch.items()})
    return half


@pytest.mark.parametrize("fault", [_unchanged, _half_batch],
                         ids=["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    line = smoke.perform(smoke.TRAIN, seed=41, fault=fault)
    assert not line["correct"], line["checks"]
