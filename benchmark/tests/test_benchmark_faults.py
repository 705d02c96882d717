"""``correct`` comes out false when the timed path is broken underneath,
and for the cell's control, with the cells' own limits: the harness's look
for a card skipped, a whole run driven on the CPU at a small size (the
port's kernels take their plain versions there), with each fault of
``faults.py`` planted in the program."""

import pytest
import torch

from benchmark import cell as cellmod, datagen, faults, spec

#: a small mix of each configuration's cells: the hybrid plans two panels
#: and an ELL tail at this size
SMALL = dict(rows=700, cols=300, train_nnz=20_000,
             plan={"ccd": {"hybrid_dense_cells": 60_000,
                           "hybrid_panel_widths": [64, 32],
                           "hybrid_transpose": False}})
CELLS = ("ccd.netflix", "als.ml20m")
SEED = 2 ** 31 + 17
CPU = torch.device("cpu")


def _cell(workload):
    c = spec.resolve(spec.load_spec(), workload)
    c.traffic = dict(c.traffic, **SMALL)
    return c


@pytest.fixture(scope="module")
def sound():
    """Per cell: the cell, its data and a sound run with its reference."""
    out = {}
    for w in CELLS:
        c = _cell(w)
        data = datagen.generate(c.traffic, SEED, CPU)
        run = cellmod.run_program(c, data, SEED, 0.0, CPU, iters=3)
        ref = cellmod.reference_run(c, data, SEED, run, CPU)
        run.readings = cellmod.readings_of(c, run, ref, data, CPU)
        out[w] = (c, data, run, ref)
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(sound, workload):
    c, _, run, _ = sound[workload]
    ok, checks = cellmod.judge(run.readings, c.limits)
    assert ok and run.failed == 0, checks


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(sound, workload, fault):
    c, data, run, ref = sound[workload]
    bad = cellmod.run_program(c, data, SEED, 0.0, CPU, iters=run.iters,
                              fault=fault)
    if cellmod.check_mode(c) == "step":
        ref = cellmod.reference_run(c, data, SEED, bad, CPU)
    ok, checks = cellmod.judge(cellmod.readings_of(c, bad, ref, data, CPU),
                               c.limits)
    assert not ok, checks


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(sound, workload):
    c, data, run, ref = sound[workload]
    low = cellmod.control_readings(c, data, SEED, run, ref, CPU)
    ok, checks = cellmod.judge(low, c.limits)
    assert not ok, checks


def test_no_limits_is_not_correct():
    assert cellmod.judge({"rmse_gap": 0.0}, None) == (False, {})


def test_faults_are_removed_after_the_block():
    from cuda_recommender_tpu_torch.solvers import als_ell, ccd_hybrid

    before = (ccd_hybrid.make_hybrid_outer_step, als_ell.als_ell_train)
    with faults.planted("half", "ccd"), faults.planted("altered", "als"):
        assert ccd_hybrid.make_hybrid_outer_step is not before[0]
        assert als_ell.als_ell_train is not before[1]
    assert (ccd_hybrid.make_hybrid_outer_step, als_ell.als_ell_train) == before
    with pytest.raises(ValueError):
        with faults.planted("no_such", "ccd"):
            pass
