"""The check fails when the timed path is broken underneath a run that
skips only the harness's look for a card: for each fault a cell can have
(one card, so no exchange between cards to leave out), and for the
control, a store that reports writes visible before quiescence."""

from __future__ import annotations

import pytest

from benchmark.harness.faults import FAULTS

from .conftest import CELLS, run_tiny


@pytest.mark.parametrize("fault", ["unchanged_step", "half_batch", "altered_answer"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_makes_the_run_incorrect(workload, fault):
    res = run_tiny(workload, seconds=0.5, faults=[FAULTS[fault]])
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["check"].values())


@pytest.mark.parametrize("seed", [3, 2**31 + 11, 77])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_on_every_seed(workload, seed):
    res = run_tiny(workload, seed=seed, seconds=0.5, faults=[FAULTS["early_answer"]])
    assert res["correct"] is False
    assert res["check"]["rows_apart"]["value"] >= 1
