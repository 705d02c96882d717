"""The port's validation scripts on the CPU against the JAX package's
records and runs: ``run_trajectories`` (the ml1m fixture through text,
convert, binfmt and training) against the committed
``results/rmse_trajectory_ml1m_*.jsonl``, ``golden_netflix_scale`` at
small dims, and ``yahoo_robustness`` at the JAX script's shrunk dims
against that script run the same way.

The JAX Yahoo script puts a fixed path first on sys.path, points JAX's
compilation cache at a fixed directory and caches its data in a fixed
one. It runs in a subprocess through ``JAX_YAHOO``, which imports this
checkout's JAX package first, restores sys.path after the script's
import, and moves both caches into the test's directory.
"""

import json
import os
import subprocess
import sys
import tempfile

import pytest

from cuda_recommender_tpu_torch.eval.metrics import GoldenResult
from cuda_recommender_tpu_torch.scripts import golden_netflix_scale
from cuda_recommender_tpu_torch.scripts import run_trajectories
from cuda_recommender_tpu_torch.scripts import yahoo_robustness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(ROOT, "results")
TRAJ_ITERS = 2
#: |port rmse_after_iters - the JAX script's| at the shrunk Yahoo dims:
#: the bf16 hybrid within the bf16 trajectory bar, f32 ALS within 1e-3
YAHOO_TOL = {"r1": 0.02, "c15": 0.02, "als_r1": 1e-3}
#: the JAX Yahoo script run with argv ROOT CACHE_DIR JOBS: this checkout's
#: JAX package, sys.path as it was, JAX's compilation cache and the data
#: cache in CACHE_DIR
JAX_YAHOO = """
import functools, importlib.util, os, sys
root, cache = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import jax
import cuda_recommender_tpu
path = list(sys.path)
spec = importlib.util.spec_from_file_location(
    "jax_yahoo_robustness", os.path.join(root, "scripts",
                                         "yahoo_robustness.py"))
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
sys.path[:] = path
jax.config.update("jax_compilation_cache_dir", os.path.join(cache, "jax"))
mod.synthetic_cached = functools.partial(mod.synthetic_cached,
                                         cache_dir=cache)
assert os.path.dirname(os.path.dirname(
    cuda_recommender_tpu.__file__)) == root
sys.argv = [spec.origin] + sys.argv[3:]
mod.main()
"""


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_run_trajectories_against_jax_records(tmp_path, capsys):
    """Every arm's first lines lie within the script's BARS of the
    committed JAX record's and meet its golden bars (main exits 0 only if
    ``compare`` finds no miss); the fp8 arm runs and writes its record;
    each record has the JAX record's line and summary keys."""
    out = tmp_path / "out"
    # a work directory that does not exist yet: the script makes it
    rc = run_trajectories.main([str(TRAJ_ITERS), str(tmp_path / "a" / "work"),
                                str(out), "--device", "cpu"])
    printed = capsys.readouterr().out
    assert rc == 0, printed
    assert "MISS" not in printed
    assert "hybrid-fp8 done" in printed
    assert (out / "rmse_trajectory_ml1m_hybrid_fp8.jsonl").exists()
    for arm in run_trajectories.BARS:
        name = f"rmse_trajectory_ml1m_{arm}.jsonl"
        got = _jsonl(out / name)
        want = _jsonl(os.path.join(RESULTS, name))
        assert len(got) == TRAJ_ITERS + 1
        assert [set(line) for line in got[:-1]] == \
            [set(line) for line in want[:TRAJ_ITERS]], arm
        assert [g["oiter"] for g in got[:-1]] == list(range(1,
                                                             TRAJ_ITERS + 1))
        assert set(got[-1]) == set(want[-1]), arm
        assert got[-1]["maxiter"] == TRAJ_ITERS
        assert got[-1]["device"]["platform"] == "cpu"
    assert _jsonl(out / "rmse_trajectory_ml1m_ccd.jsonl")[-1][
        "golden_W"] == "Check... PASS!"


def _records_as_run(arm, iters=15):
    """The JAX record of ``arm`` in the shape ``run`` returns, with golden
    verdicts that pass."""
    ok = GoldenResult(passed=True, error_count=0, total=100)
    return {"lines": run_trajectories.jax_records()[arm][:iters],
            "golden": {"W": ok, "H": ok}}


#: a fault planted in the JAX records (read as a run of the port) and the
#: miss ``compare`` must report for it
FAULTS = {
    "ccd_golden_fails": ("ccd", "golden_W", "ccd: golden_W"),
    "als_golden_1pct": ("als", "golden_H", "als: golden_H 1.0000% off"),
    "hybrid_golden_gap": ("hybrid_bf16_nan_kernel", "gap",
                          "hybrid_bf16_nan_kernel iteration 3: |compiled"),
    "ccd_off_jax": ("ccd", "jax", "ccd iteration 2: compiled |diff|"),
    "als_missing": ("als", "drop", "als: no run"),
}


def test_compare_passes_the_jax_records():
    """The JAX records themselves, read as a run, meet every bar: the
    hybrids' golden gaps (at most 6.16e-4 at 15 iterations) lie under
    HYBRID_GOLDEN_GAP."""
    out = {arm: _records_as_run(arm) for arm in run_trajectories.BARS}
    assert run_trajectories.compare(out, run_trajectories.jax_records()) \
        == []


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_compare_reports_misses(fault):
    """Each planted fault gives exactly its miss: a failed dense golden,
    ALS at 1% of entries off, a hybrid 1.5e-3 off its golden RMSE at one
    iteration, dense CCD++ 2e-3 off the JAX record, an arm that never
    ran."""
    arm, kind, want = FAULTS[fault]
    out = {name: _records_as_run(name) for name in run_trajectories.BARS}
    rec = out[arm]
    if kind == "golden_W":
        rec["golden"]["W"] = GoldenResult(passed=False, error_count=1,
                                          total=100)
    elif kind == "golden_H":
        rec["golden"]["H"] = GoldenResult(passed=False, error_count=1,
                                          total=100)
    elif kind in ("gap", "jax"):
        i, off = (2, 1.5e-3) if kind == "gap" else (1, 2e-3)
        line = rec["lines"][i]
        rec["lines"][i] = dict(line, rmse_compiled=round(
            line["rmse_compiled"] + off, 6))
    else:
        del out[arm]
    misses = run_trajectories.compare(out, run_trajectories.jax_records())
    assert len(misses) == 1 and misses[0].startswith(want), misses


def test_golden_netflix_scale_small(tmp_path):
    """The script's main at cut dims through its function arguments: f32
    passes golden_compare on W and H, bf16 writes the determination
    histogram, and each record has the JAX record's keys plus
    ``rmse_golden_jax``."""
    rc = golden_netflix_scale.main(
        ["float32,bfloat16", "--out-dir", str(tmp_path), "--device", "cpu"],
        dims=(3000, 500, 60_000, 8, 0.05), budget=300_000, widths=(128, 64))
    assert rc == 0
    # the JAX record's keys, less the "interpretation" its authors added
    # by hand (the JAX script writes none)
    with open(os.path.join(RESULTS, "golden_netflix_100m_bf16_r5.json")) as f:
        jax_keys = set(json.load(f)) - {"interpretation"}
    hist = {"determination_histogram_W", "determination_histogram_H"}
    recs = {}
    for rdt in ("float32", "bfloat16"):
        with open(tmp_path / f"golden_netflix_100m_{rdt}.json") as f:
            recs[rdt] = json.load(f)
    f32, bf16 = recs["float32"], recs["bfloat16"]
    assert f32["golden_W"]["passed"] and f32["golden_H"]["passed"]
    assert set(f32) == (jax_keys - hist) | {"rmse_golden_jax"}
    assert not (bf16["golden_W"]["passed"] and bf16["golden_H"]["passed"])
    assert set(bf16) == jax_keys | {"rmse_golden_jax"}
    assert f32["rmse_golden"] == bf16["rmse_golden"]
    assert max(abs(a - b) for a, b in zip(f32["rmse_hybrid"],
                                          f32["rmse_golden"])) <= 1e-3
    assert bf16["hardware"] == {"platform": "cpu", "name": "cpu"}


def test_yahoo_robustness_against_jax_script(tmp_path, monkeypatch):
    """r1, c15 and als_r1 at the shrunk dims (CRTPU_BENCH_CPU=1, --device
    cpu): rmse_after_iters within YAHOO_TOL of the JAX script run the same
    way in a subprocess (started first, so the two run side by side)."""
    jobs = ",".join(YAHOO_TOL)
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    env = dict(os.environ, CRTPU_BENCH_CPU="1", JAX_PLATFORMS="cpu",
               TMPDIR=str(jax_dir))
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_YAHOO, ROOT, str(jax_dir), jobs],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        monkeypatch.setenv("CRTPU_BENCH_CPU", "1")
        # the port's data cache in this test's directory
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
        out = tmp_path / "yahoo.jsonl"
        assert yahoo_robustness.main([jobs, "--out", str(out), "--device",
                                      "cpu"]) == 0
        stdout, stderr = jax_run.communicate(timeout=240)
    finally:
        jax_run.kill()
    assert jax_run.returncode == 0, stderr[-2000:]
    want = {rec["name"]: rec for rec in map(json.loads, stdout.splitlines())}
    got = {rec["name"]: rec for rec in _jsonl(out)}
    assert set(got) == set(want) == set(YAHOO_TOL)
    for name, tol in YAHOO_TOL.items():
        assert abs(got[name]["rmse_after_iters"]
                   - want[name]["rmse_after_iters"]) <= tol, name
        assert got[name]["iterations"] == 7
        assert got[name]["iter_s"] is None          # no card: not measured
    for name in ("r1", "c15"):
        assert got[name]["panels"] == want[name]["panels"]
        assert got[name]["nnz_light_frac"] == pytest.approx(
            want[name]["nnz_light_frac"], abs=1e-4)
    assert got["als_r1"]["gather_tiling"] is None
    assert got["als_r1"]["resolved_floors"] == \
        want["als_r1"]["resolved_floors"]


def test_yahoo_write_record_replaces_a_jobs_line(tmp_path):
    """A job's new record takes the place of its old line; another job's
    goes after the last: reruns leave one line a job."""
    path = str(tmp_path / "sub" / "y.jsonl")
    yahoo_robustness.write_record(path, {"name": "r1", "v": 1})
    yahoo_robustness.write_record(path, {"name": "als_r1", "v": 2})
    yahoo_robustness.write_record(path, {"name": "r1", "v": 3})
    assert _jsonl(path) == [{"name": "r1", "v": 3},
                            {"name": "als_r1", "v": 2}]


def test_yahoo_robustness_cpu_needs_shrunk_dims(monkeypatch, capsys):
    """--device cpu without CRTPU_BENCH_CPU=1 (full dims) and the shrunk
    dims on the card are refused with exit code 2."""
    monkeypatch.delenv("CRTPU_BENCH_CPU", raising=False)
    assert yahoo_robustness.main(["r1", "--device", "cpu", "--out", ""]) == 2
    monkeypatch.setenv("CRTPU_BENCH_CPU", "1")
    assert yahoo_robustness.main(["r1", "--out", ""]) == 2
    assert "go together" in capsys.readouterr().err
