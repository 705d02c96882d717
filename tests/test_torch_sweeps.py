"""The port's sweep scripts on the CPU against the JAX package's:
``scripts/sweep.py`` (the reference grid through ``cli/bench.py``) against
the JAX ``cli/bench.py`` on the same argv and against the committed ``r2``
records, ``scripts/sweep_netflix_hybrid.py`` on its CPU grid against the
JAX script run the same way, and ``scripts/bench_als.py``'s golden part
against the JAX package's ALS at the same settings.

The JAX flagship script puts a fixed path first on sys.path, points JAX's
compilation cache at a fixed directory and caches its data in a fixed
one; it runs in a subprocess through ``JAX_SCRIPT``, which imports this
checkout's JAX package first, restores sys.path after the script's
import, and moves both caches into the test's directory.
"""

import copy
import json
import math
import os
import subprocess
import sys
import tempfile

import pytest
import torch

from cuda_recommender_tpu.cli import bench as jbench
from cuda_recommender_tpu_torch.scripts import bench_als
from cuda_recommender_tpu_torch.scripts import sweep
from cuda_recommender_tpu_torch.scripts import sweep_netflix_hybrid as snh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")
#: the grid of the sweep test: sweep.sh's shape, cut
SPEC = "synthetic:m=300,n=120,nnz=6000"
GRID = dict(ks="2,4", inners="1,3", repeats=2, iters=3)
#: |port final_rmse - JAX final_rmse| allowed. The JAX records round to
#: five decimals (up to 5e-6 off); measured at most 5.01e-6 (CCD++) and
#: 1.01e-6 (ALS) in all
SWEEP_TOL = {"ccd": 1e-5, "als": 1e-5}
#: the flagship CPU grid: |port - JAX rmse_after_iters| within the bf16
#: trajectory bar (measured: at most 5.8e-5, the JAX lines' 4-decimal
#: rounding included)
FLAGSHIP_TOL = 0.02
#: bench_als part 2 at cut iterations: |port RMSE - JAX RMSE| allowed
BENCH_ALS_ITERS = 3
BENCH_ALS_TOL = 1e-4
#: a JAX script run with argv ROOT CACHE_DIR NAME ARGS...: this checkout's
#: JAX package, sys.path as it was, JAX's compilation cache and the data
#: cache in CACHE_DIR
JAX_SCRIPT = """
import functools, importlib.util, os, sys
root, cache, name = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path.insert(0, root)
import jax
import cuda_recommender_tpu
path = list(sys.path)
spec = importlib.util.spec_from_file_location(
    "jax_" + name, os.path.join(root, "scripts", name + ".py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
sys.path[:] = path
jax.config.update("jax_compilation_cache_dir", os.path.join(cache, "jax"))
mod.synthetic_cached = functools.partial(mod.synthetic_cached,
                                         cache_dir=cache)
assert os.path.dirname(os.path.dirname(
    cuda_recommender_tpu.__file__)) == root
sys.argv = [spec.origin] + sys.argv[4:]
mod.main()
"""


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads in this module: the suite runs test files side
    by side, and tensors this small on every core's thread oversubscribe
    the host (a tenfold slowdown under a full suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """The cut grid through the port's sweep (fixed seed) and through the
    JAX cli/bench.py, a call a solver as sweep.sh makes them."""
    d = tmp_path_factory.mktemp("sweep")
    port = sweep.run(SPEC, str(d / "port.jsonl"), device="cpu", **GRID)
    for solver in ("ccd", "als"):
        argv = sweep._argv(SPEC, solver, GRID["ks"], GRID["inners"],
                           GRID["iters"], GRID["repeats"], False,
                           str(d / "jax.jsonl"), "cpu")
        assert jbench.main(argv[:-2]) == 0          # no --device in JAX's
    return port, _jsonl(d / "jax.jsonl"), _jsonl(d / "port.jsonl")


@pytest.mark.parametrize("solver", ["ccd", "als"])
def test_sweep_against_jax_bench(grids, solver):
    """The same cells (solver, k, inner, repeat, seed) as the JAX
    cli/bench.py on the same argv, each final_rmse within SWEEP_TOL; the
    records appended to the output file carry the dataset and the
    device."""
    port, jax_recs, written = grids
    got = {sweep._key(r): r for r in port if r["solver"] == solver}
    want = {sweep._key(r): r for r in jax_recs if r["solver"] == solver}
    assert set(got) == set(want)
    assert len(got) == 2 * GRID["repeats"] * (2 if solver == "ccd" else 1)
    for key, rec in got.items():
        assert abs(rec["final_rmse"] - want[key]["final_rmse"]) <= \
            SWEEP_TOL[solver], key
        assert rec["backend"] == want[key]["backend"]
    assert written == port
    assert all(r["dataset"] == SPEC and r["card"]["platform"] == "cpu"
               for r in port)


def test_sweep_repeats_bit_equal(grids):
    """Under the fixed seed every repeat of a cell ends at the same
    final_rmse bit for bit."""
    port = grids[0]
    assert sweep.repeat_mismatches(port) == []
    by = {}
    for r in port:
        by.setdefault((r["solver"], r["k"], r["inner"]), []).append(
            r["final_rmse"])
    assert all(len(v) == 2 and v[0] == v[1] for v in by.values())
    # a planted difference is reported
    bad = copy.deepcopy(port)
    bad[1]["final_rmse"] += 1e-12
    assert len(sweep.repeat_mismatches(bad)) == 1


@pytest.mark.parametrize("record", sorted(sweep.JAX_SWEEPS))
def test_sweep_compare_passes_jax_records(record):
    """The JAX r2 record read as a run (seed = repeat, as it ran) meets
    every bar of compare."""
    recs = sweep.read_jsonl(sweep.JAX_SWEEPS[record])
    run = [dict(r, seed=r["repeat"]) for r in recs]
    misses, pairs = sweep.compare(run, recs)
    assert misses == []
    assert len(pairs) == len(recs)


#: a fault planted in the ml10M record read as a run, and the miss compare
#: must give for it
SWEEP_FAULTS = {
    "ccd_off": ("ccd k=10 T=3 repeat=1", "|final_rmse - JAX| 0.0015 "),
    "als_off": ("als k=40 T=1 repeat=2", "|final_rmse - JAX| 0.015 "),
    "no_run": ("ccd k=50 T=7 repeat=0", "no run"),
    "other_iters": ("als k=1 T=1 repeat=0", "λ 0.1, 9 iterations"),
    "other_seed": ("ccd k=5 T=5 repeat=2", "no run"),
}


@pytest.mark.parametrize("fault", sorted(SWEEP_FAULTS))
def test_sweep_compare_reports_misses(fault):
    """Each planted fault gives exactly its miss: CCD++ 1.5e-3 and ALS
    1.5e-2 off the record, a cell never run, a cell at another iteration
    count, a cell run at a seed other than the record's. A cell 9e-4 off
    (under the CCD bar) gives none."""
    recs = sweep.read_jsonl(sweep.JAX_SWEEPS["ml10m"])
    run = [dict(r, seed=r["repeat"]) for r in recs]
    cell, want = SWEEP_FAULTS[fault]
    idx = next(i for i, r in enumerate(run)
               if f"{r['solver']} k={r['k']} T={r['inner']} repeat="
                  f"{r['repeat']}" == cell)
    rec = run[idx]
    if fault == "ccd_off":
        rec["final_rmse"] += 1.5e-3
    elif fault == "als_off":
        rec["final_rmse"] += 1.5e-2
    elif fault == "no_run":
        del run[idx]
    elif fault == "other_iters":
        rec["iters"] = 9
    else:
        rec["seed"] = 0
    near = next(r for r in run if r["solver"] == "ccd" and r["k"] == 1)
    near["final_rmse"] += 9e-4
    misses, _ = sweep.compare(run, recs)
    assert len(misses) == 1 and misses[0].startswith(cell), misses
    assert want in misses[0], misses


def test_sweep_main_compare_exit_code(tmp_path, capsys):
    """main exits 0 on a clean fixed-seed run and 1 when --compare finds a
    miss (the cut grid against a record whose cells it never ran)."""
    out = tmp_path / "s.jsonl"
    args = [SPEC, str(out), "--ks", "2", "--inners", "1", "--iters", "2",
            "--repeats", "2", "--device", "cpu"]
    assert sweep.main(args) == 0
    assert len(_jsonl(out)) == 4
    assert sweep.main(args + ["--compare",
                              sweep.JAX_SWEEPS["ml20m_als"]]) == 1
    assert "MISS als k=10 T=1 repeat=0 seed=0: no run" in \
        capsys.readouterr().out


def test_flagship_against_jax_script(tmp_path, monkeypatch):
    """The CPU grid (CRTPU_BENCH_CPU=1, --device cpu) against the JAX
    script run the same way in a subprocess, started first so that the two
    run side by side: the same plans (panels, tail share), RMSEs within
    FLAGSHIP_TOL, the JAX keys (less device) plus the port's, times null,
    the repeats in turns."""
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    env = dict(os.environ, CRTPU_BENCH_CPU="1", JAX_PLATFORMS="cpu",
               TMPDIR=str(jax_dir), OMP_NUM_THREADS="2",
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")
    env.pop("CRTPU_DEFER_GROUP", None)
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, ROOT, str(jax_dir),
         "sweep_netflix_hybrid"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        monkeypatch.setenv("CRTPU_BENCH_CPU", "1")
        monkeypatch.delenv("CRTPU_DEFER_GROUP", raising=False)
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        out = tmp_path / "flagship.jsonl"
        assert snh.main(["--device", "cpu", "--out", str(out)]) == 0
        stdout, stderr = jax_run.communicate(timeout=240)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, stderr[-2000:]
    want = [json.loads(x) for x in stdout.splitlines() if x.startswith("{")]
    got = _jsonl(out)
    assert len(got) == len(want) == 4
    assert [(r["row"], r["repeat"]) for r in got] == \
        [(0, 0), (1, 0), (0, 1), (1, 1)]
    port_only = {"row", "launches", "iter_s_group_samples", "iterations",
                 "rmse_after_iters_jax", "rmse_jax_record"}
    for rec in got:
        ref = next(r for r in want if r["widths"] == rec["widths"]
                   and r["repeat"] == rec["repeat"])
        assert set(rec) - port_only == set(ref)
        assert rec["panels"] == ref["panels"]
        assert rec["nnz_light_frac"] == ref["nnz_light_frac"]
        assert abs(rec["rmse_after_iters"] - ref["rmse_after_iters"]) <= \
            FLAGSHIP_TOL
        assert rec["iter_s"] is None and rec["compile_s"] is None
        assert rec["iterations"] == 1 + snh.PAIRS * (1 + snh.CPU_GROUP)
        assert rec["device"] == {"platform": "cpu", "name": "cpu"}


def test_flagship_refuses_what_the_port_lacks(monkeypatch, capsys,
                                             tmp_path):
    """CRTPU_DEFER_GROUP above 0 runs the rank-deferred tail, as the JAX
    script does (a CPU row: its lines record the group); the CPU grid
    needs --device cpu and the full grid the card (exit 2)."""
    monkeypatch.setenv("CRTPU_BENCH_CPU", "1")
    monkeypatch.setenv("CRTPU_DEFER_GROUP", "2")
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "defer.jsonl"
    assert snh.main(["rows=0", "--device", "cpu", "--out", str(out)]) == 0
    recs = _jsonl(out)
    assert [r["defer_group"] for r in recs] == [2, 2]
    assert all(math.isfinite(r["rmse_after_iters"]) for r in recs)
    monkeypatch.delenv("CRTPU_DEFER_GROUP")
    assert snh.main(["--out", ""]) == 2
    monkeypatch.delenv("CRTPU_BENCH_CPU")
    assert snh.main(["--device", "cpu", "--out", ""]) == 2
    assert "go together" in capsys.readouterr().err


def test_flagship_grid_turns_and_jax_rows():
    """The full grid: 15 rows x 2 repeats, the hand and auto stairs at
    each shared (k, budget, T) in turns, every row with a JAX row (r5
    before r4), and rmse_misses finding exactly a planted 0.03 miss."""
    order = snh.turns(snh.GRID, list(range(len(snh.GRID))), snh.REPEATS)
    assert len(order) == 30 and len(set(order)) == 30
    for hand, auto in ((3, 6), (4, 7), (5, 8), (9, 10)):
        i = order.index((hand, 0))
        assert order[i:i + 4] == [(hand, 0), (auto, 0), (hand, 1),
                                  (auto, 1)]
    rows = snh.jax_rows()
    keys = [(k, snh.BUDGETS[b], w, t) for k, b, w, t in snh.GRID]
    assert all(key in rows for key in keys)
    assert rows[(40, 2_000_000_000, snh.HAND, 1)] == (
        0.179, "sweep_netflix_hybrid_r5.jsonl")
    assert rows[(40, 6_500_000_000, "auto", 1)][1] == \
        "sweep_netflix_hybrid_r4.jsonl"
    recs = [{"row": i, "repeat": 0, "k": k, "budget_cells": snh.BUDGETS[b],
             "widths": w, "inner": t, "rmse_after_iters": rows[key][0],
             "rmse_after_iters_jax": rows[key][0]}
            for i, ((k, b, w, t), key) in enumerate(zip(snh.GRID, keys))]
    assert snh.rmse_misses(recs) == []
    recs[5]["rmse_after_iters"] += 0.03
    misses = snh.rmse_misses(recs)
    assert len(misses) == 1 and misses[0].startswith("row 5 "), misses


@pytest.fixture(scope="module")
def jax_part2():
    """The JAX script's part 2 (bench_als_tpu.py:90-119) on the CPU at
    BENCH_ALS_ITERS iterations: RMSE at "high" and "default"."""
    from cuda_recommender_tpu.core.config import Config as JConfig
    from cuda_recommender_tpu.core.init import init_factors_np as jinit
    from cuda_recommender_tpu.data.datasets import ml1m_like as jml1m
    from cuda_recommender_tpu.eval.metrics import calrmse_np as jrmse
    from cuda_recommender_tpu.solvers.als_ell import als_ell_train as jals

    R, T = jml1m(seed=0)
    W0, H0 = jinit(10, R.rows, R.cols, seed=0, entity_major=True)
    out = {}
    for prec in ("high", "default"):
        cfg = JConfig(solver="als", k=10, maxiter=BENCH_ALS_ITERS,
                      lambda_=0.05, als_precision=prec, fused_outer_iters=10)
        Wc, Hc, _ = jals(R, W0.copy(), H0.copy(), T, cfg)
        out[prec] = jrmse(T, Wc, Hc, entity_major=True)
    return out


def test_bench_als_golden_against_jax(jax_part2):
    """Part 2 at cut iterations on the CPU: "high" passes the golden on W
    and H, both precisions meet golden_misses' bars, and each RMSE lies
    within BENCH_ALS_TOL of the JAX package's run at that precision."""
    gold = bench_als.golden_run(dev="cpu", maxiter=BENCH_ALS_ITERS)
    assert gold["high"]["W"].passed and gold["high"]["H"].passed
    assert bench_als.golden_misses(gold, jax_rmse=None) == []
    for prec in ("high", "default"):
        assert abs(gold[prec]["rmse"] - jax_part2[prec]) <= BENCH_ALS_TOL
    # the golden gates catch a run off its golden
    bad = dict(gold, high=dict(gold["high"], rmse=gold["golden_rmse"]
                               + 2e-4))
    assert len(bench_als.golden_misses(bad, jax_rmse=None)) == 1


def test_bench_als_main_cpu(tmp_path):
    """main on the CPU: part 1 at its cut dims (times null, K5's launches
    none: the plain solve), part 2 as the JAX script runs it ("high"
    within 1e-4 of the JAX record's 0.77652); the record has the JAX
    RESULT's keys (results/als_ml20m_r2.json) and the port's."""
    out = tmp_path / "bench_als.json"
    assert bench_als.main(["--device", "cpu", "--out", str(out)]) == 0
    with open(out) as f:
        rec = json.load(f)
    with open(os.path.join(RESULTS, "als_ml20m_r2.json")) as f:
        jax_keys = set(json.load(f))
    assert jax_keys <= set(rec)
    assert {"iter_s_default", "default_golden_W_pass",
            "default_golden_H_pass", "default_within_als_bar",
            "ml1m_rmse_default_vs_golden", "card"} <= set(rec)
    assert rec["iter_s_highest"] is None and rec["iter_s_default"] is None
    assert rec["round1_baseline_s"] is None
    assert rec["high_golden_W_pass"] and rec["high_golden_H_pass"]
    assert set(rec["steps"]) == {"highest", "high", "default"}
    assert rec["card"] == {"platform": "cpu", "name": "cpu"}
