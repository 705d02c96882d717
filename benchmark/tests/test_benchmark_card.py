"""On the card, at each cell's own size: a run proves correct, and the
cell's control does not. Run with ``python -m pytest benchmark/tests -m
card``; every test here skips without a card."""

import pytest

from benchmark import cell as cellmod, datagen, spec

#: one seed these tests use (no limit was set from it)
SEED = 4_000_000_007


def _cells():
    return [w["name"] for w in spec.load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", _cells())
def test_cell_correct_and_control_not(card_device, workload):
    c = spec.resolve(spec.load_spec(), workload)
    data = datagen.generate(c.traffic, SEED, card_device)
    cellmod._free(card_device)
    out = cellmod.run_cell(c, SEED, 5.0, card_device, data=data)
    ok, checks = cellmod.judge(out.readings, c.limits)
    assert ok and out.failed == 0, checks
    ref = cellmod.reference_run(c, data, SEED, out, card_device)
    low = cellmod.control_readings(c, data, SEED, out, ref, card_device)
    bad, checks = cellmod.judge(low, c.limits)
    assert not bad, checks
