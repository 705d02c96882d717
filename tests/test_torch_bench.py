"""The port's measurement entry points on the CPU, at a tiny size.

``python -m cuda_recommender_tpu_torch.bench`` must print one parseable JSON
line whose RMSE equals ``train()``'s on the same configuration (the same
kernels' plain versions, the same number of outer iterations) and whose
``vs_baseline`` is null off the card; ``cli/bench.py`` one record per grid
point; the probe scripts run through. Without ``--device cpu`` and without
a card, each exits non-zero before it prints a result.
"""

import io
import json
import math
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch import bench
from cuda_recommender_tpu_torch.cli import bench as cli_bench
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.scripts import fp8_runs, panel_floor, \
    panel_kernel_variants, probe_gather, profile_iteration, sweep_timing
from cuda_recommender_tpu_torch.solvers import ccd_hybrid as ch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--m", "300", "--n", "120", "--nnz", "6000", "--k", "4", "--budget",
        "12000", "--iters", "3", "--warmup", "1", "--device", "cpu"]


@pytest.fixture(autouse=True)
def own_tempdir(tmp_path, monkeypatch):
    """synthetic_cached writes its cache to the temp directory. The cache
    is written first, so that the bench and train() both load it: the
    generating call returns the matrix with its columns' entries in draw
    order, a load in row order, and a transposed run walks the columns."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    datasets.synthetic_cached(300, 120, 6000, seed=1, test_fraction=0.02)


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


def _bench(extra=()):
    rc, lines = _run(bench.main, TINY + list(extra))
    assert rc == 0 and len(lines) == 1
    return json.loads(lines[0])


def _train_rmse(transpose, widths):
    R, T = datasets.synthetic_cached(300, 120, 6000, seed=1,
                                     test_fraction=0.02)
    cfg = Config(k=4, lambda_=0.05, maxiter=4, backend="hybrid",
                 residual_dtype="bfloat16", mask_dtype="nan",
                 hybrid_panel_kernel=True, hybrid_dense_cells=12000,
                 hybrid_panel_widths=widths, hybrid_transpose=transpose)
    res = train(cfg, R, T, device="cpu", log=MetricsLog(None))
    return res.stats[-1].rmse, R.nnz, ch.resolve_hybrid_transpose(R, cfg)


@pytest.mark.parametrize("widths,transpose", [
    ("4096,2048", "0"), ("32,16", "0"), ("auto", "0"), ("32,16", "1"),
    ("32,16", "auto")])
def test_bench_line_and_rmse_equal_train(widths, transpose):
    rec = _bench(["--panel-widths", widths, "--transpose", transpose])
    d = rec["detail"]
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert rec["metric"] == "ccd_netflix_scale_throughput"
    assert rec["vs_baseline"] is None
    assert d["vs_baseline_achievable"] is None
    assert d["device"] == {"platform": "cpu", "name": "cpu"}
    assert d["iterations_run"] == 4 and len(d["iter_s_samples"]) == 3
    want_w = ("auto" if widths == "auto"
              else tuple(int(w) for w in widths.split(",")))
    want_t = "auto" if transpose == "auto" else bool(int(transpose))
    rmse, nnz, transposed = _train_rmse(want_t, want_w)
    assert d["test_rmse"] == rmse
    assert math.isclose(rec["value"], nnz * 4 / d["outer_iter_s"] / 1e6)
    assert d["outer_iter_s"] == float(np.median(d["iter_s_samples"]))
    # CPU: plain versions, no launch, and no control measured
    assert set(d["launches"].values()) == {0}
    assert set(d["controls"]["launches"].values()) == {0}
    for r in d["controls"]["panels"]:
        assert all(r[m]["ms"] is None for m in panel_floor.CONTROLS)
    assert (d["orientation"] == "transposed (items as rows)") == transposed
    assert transposed == (transpose == "1")   # auto keeps users as rows here


def test_bench_counts_the_tail_and_the_ideal():
    rec = _bench(["--panel-widths", "32,16"])
    d = rec["detail"]
    R, _ = datasets.synthetic_cached(300, 120, 6000, seed=1,
                                     test_fraction=0.02)
    cfg = Config(backend="hybrid", hybrid_dense_cells=12000,
                 hybrid_panel_widths=(32, 16), mask_dtype="nan")
    plan = ch.plan_hybrid(R, cfg, materialize_dense=False)
    assert d["panels"] == [list(p) for p in plan.panels]
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    assert d["tail"]["rows"]["lanes"] == sum(b.idx.size for b in rows.buckets)
    assert d["tail"]["cols"]["lanes"] == sum(b.idx.size for b in cols.buckets)
    assert d["tail"]["rows"]["table_rows"] == R.cols + 1
    tail = sum(s["lanes"] * 16 + s["slots"] * 16
               + s["table_rows"] * s["width"] * 4
               for s in d["tail"].values())
    cells = sum((r1 - r0) * w for r0, r1, w in plan.panels)
    assert d["panel_cells"] == cells
    assert math.isclose(d["ideal_s_per_iter"],
                        4 * (6 * cells + tail) / 3.35e12)
    assert d["nnz_light_frac"] == plan.nnz_light / R.nnz


def test_achievable_from_measured_controls():
    """The panel controls named in bench.ACHIEVABLE (panel_floor's modes
    "rmw" and "read", one design each) stand for the card; a control not
    named would ride along and not enter."""
    assert bench.ACHIEVABLE == ("rmw", "read")
    assert set(panel_floor.CONTROLS) == {"rmw", "read"}
    rmw, read = bench.ACHIEVABLE
    assert rmw.startswith("rmw") and read.startswith("read")
    ms = {rmw: (1.5, 0.5), read: (0.75, 0.25)}
    ctl = {"panels": [{m: {"ms": ms.get(m, (9.0, 9.0))[i]}
                       for m in panel_floor.CONTROLS} for i in (0, 1)],
           "gathers": {"rows": {"B": {"ns_per_element": 0.01}}}}
    sides = {"rows": {"lanes": 1_000_000}}
    # k x ((1.5 + 0.75) + (0.5 + 0.25) + 1e6 lanes x 1e-8 ms) ms
    assert math.isclose(bench.achievable_s(10, ctl, sides),
                        10 * (3.0 + 0.01) / 1e3)
    ctl["panels"][0][read]["ms"] = None
    assert bench.achievable_s(10, ctl, sides) is None


def test_cli_bench_one_record_per_grid_point(tmp_path):
    out = tmp_path / "grid.jsonl"
    argv = ["--device", "cpu", "--dataset", "synthetic:m=300,n=120,nnz=6000",
            "--ks", "3,5", "--inners", "1,2", "--solvers", "ccd,als",
            "--iters", "3", "-o", str(out)]
    rc, lines = _run(cli_bench.main, argv)
    recs = [json.loads(x) for x in lines]
    assert rc == 0
    # ccd: 2 k x 2 T; als: 2 k at the first T only (times.sh)
    assert [(r["solver"], r["k"], r["inner"]) for r in recs] == [
        ("ccd", 3, 1), ("ccd", 3, 2), ("ccd", 5, 1), ("ccd", 5, 2),
        ("als", 3, 1), ("als", 5, 1)]
    assert all(r["device"] == "cpu" and math.isfinite(r["final_rmse"])
               for r in recs)
    assert [json.loads(x) for x in out.read_text().splitlines()] == recs
    # the point (ccd, k=3, T=2) is train()'s run
    R, T = datasets.synthetic_from_spec("synthetic:m=300,n=120,nnz=6000")
    res = train(Config(k=3, maxiter=3, maxinneriter=2), R, T, device="cpu",
                log=MetricsLog(None))
    assert recs[1]["final_rmse"] == res.stats[-1].rmse
    assert recs[0]["backend"] == "dense" and recs[4]["backend"] == "ell"


def test_cli_bench_hybrid_flags_and_ref():
    argv = ["--device", "cpu", "--dataset", "synthetic:m=300,n=120,nnz=6000",
            "--ks", "4", "--solvers", "ccd", "--backend", "hybrid",
            "--budget", "12000", "--panel-widths", "32,16",
            "--residual-dtype", "bfloat16", "--mask-dtype", "nan",
            "--panel-kernel", "--iters", "3", "--repeats", "2"]
    rc, lines = _run(cli_bench.main, argv)
    recs = [json.loads(x) for x in lines]
    assert rc == 0 and len(recs) == 2
    assert recs[0]["cfg"]["hybrid_panel_widths"] == [32, 16]
    assert recs[0]["final_rmse"] == recs[1]["final_rmse"]   # fixed seed
    rc, lines = _run(cli_bench.main, ["--device", "cpu", "--dataset",
                                      "synthetic:m=60,n=30,nnz=600",
                                      "--ks", "2", "--solvers", "ccd",
                                      "--backend", "ref", "--iters", "2"])
    assert rc == 0 and json.loads(lines[0])["backend"] == "ref"


def test_cli_bench_dataset_dir_names_its_roadmap_item(tmp_path):
    """A dataset directory raised ROADMAP.md queue 1 item 18 (dataset
    loaders) until that item was ported; it now loads as the JAX CLI loads
    it (``binfmt.load_binary_dataset``), and a directory without a
    manifest is an error."""
    from cuda_recommender_tpu_torch.data import binfmt
    with pytest.raises(FileNotFoundError, match="meta_modified_all"):
        cli_bench.main(["--device", "cpu", "--dataset", str(tmp_path)])
    R, T = datasets.synthetic(m=60, n=30, nnz=600, seed=2)
    binfmt.write_binary_dataset(str(tmp_path), R, T)
    rc, lines = _run(cli_bench.main, ["--device", "cpu", "--dataset",
                                      str(tmp_path), "--ks", "2",
                                      "--solvers", "ccd", "--iters", "2"])
    rec = json.loads(lines[0])
    assert rc == 0 and len(lines) == 1 and math.isfinite(rec["final_rmse"])


@pytest.mark.parametrize("module,argv", [
    ("cuda_recommender_tpu_torch.bench", ["--m", "40", "--n", "25",
                                          "--nnz", "400"]),
    ("cuda_recommender_tpu_torch.cli.bench",
     ["--dataset", "synthetic:m=40,n=25,nnz=400", "--ks", "2"])])
def test_no_card_exits_nonzero(module, argv, tmp_path):
    """No card and no --device cpu: a non-zero exit and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", TMPDIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-m", module, *argv], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=env)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "--device cpu" in res.stderr


def test_panel_floor_script_on_cpu():
    rc, lines = _run(panel_floor.main, ["--device", "cpu", "--shapes",
                                        "1100x260,600x64"])
    recs = [json.loads(x) for x in lines]
    assert rc == 0 and [r["shape"] for r in recs[:2]] == [[1100, 260],
                                                          [600, 64]]
    assert set(recs[0]) == {"shape", "rmw", "read", "uv", "us"}
    assert recs[2]["implied"]["panel_ms_per_rank"] is None
    assert math.isclose(recs[2]["implied"]["bound_s_per_iter"],
                        6 * (1100 * 260 + 600 * 64) * 40 / 3.35e12)


def test_variant_matrix_script_on_cpu():
    rc, lines = _run(panel_kernel_variants.main, ["700", "300", "--device",
                                                  "cpu"])
    out = json.loads(lines[-1])
    assert rc == 0
    assert out["A1_vs_A0"] == {"bit_mismatches": 0, "cells": 700 * 300,
                               "max_abs_g_diff": 0.0}


def test_variant_matrix_reports_16_byte_floors():
    """The floors come in 16-byte vectors (one design each), beside the
    PyTorch call that does the same work, each a line of its own and a key
    of the summary."""
    rc, lines = _run(panel_kernel_variants.main, ["70", "30", "--device",
                                                  "cpu"])
    out = json.loads(lines[-1])
    assert rc == 0
    tags = ("rmw_floor", "read_floor", "rmw_add_", "read_nansum")
    assert {key for key in out if key.startswith(("rmw", "read"))} == \
        set(tags)
    for tag in tags:
        assert tag in out and out[tag]["GB_s"] is None
        assert any(line.split(":")[0].strip() == tag for line in lines)


def test_sweep_timing_script_on_cpu(monkeypatch):
    """One line per column sweep and K5 width (each against its plain
    version; K5 also against torch.linalg.solve) and a JSON summary naming
    this checkout; on the CPU every time is "not measured"."""
    monkeypatch.setattr(sweep_timing, "NAN_SHAPES", ((70, 33), (9, 301)))
    monkeypatch.setattr(sweep_timing, "MASKED_SHAPE", (40, 17))
    monkeypatch.setattr(sweep_timing, "VARIANT_SHAPE", (50, 90))
    monkeypatch.setattr(sweep_timing, "GJ_S", 37)
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc, lines = _run(sweep_timing.main, ["--device", "cpu"])
    out = json.loads(lines[-1])
    assert rc == 0 and out["root"] == ROOT
    names = [k.split(" ")[0] for k in out["kernels"]]
    assert names.count("panel_update_vsweep") == 3
    assert names.count("panel_usweep") == names.count("panel_vsweep") == 2
    assert names.count("fused_update_vsweep") == 4
    assert names.count("masked_usweep") == 4
    assert names.count("masked_vsweep") == 4
    assert names.count("panel_update_vsweep_irne") == 1
    assert [k for k in out["kernels"] if k.startswith("gj_solve")] == [
        f"gj_solve S=37 k={k}" for k in sweep_timing.GJ_KS]
    for r in out["kernels"].values():
        assert r["ms"] is None and r["plain_ms"] is None
        assert r["library_ms"] is None
        assert r["bytes"] > 0 and r["flops"] > 0
    gj = out["kernels"]["gj_solve S=37 k=40"]
    assert gj["bytes"] == 4 * 37 * (40 * 40 + 2 * 40)
    assert gj["flops"] == 37 * 40 * 40 * 41
    assert len(lines) == 1 + len(out["kernels"])


def test_sweep_timing_streams_on_cpu(monkeypatch):
    """``--streams``: the rmw, the weighted and the NaN-skip read at each
    stream shape, each beside its plain version and its PyTorch call,
    bytes as the bound counts them, times "not measured" on the CPU."""
    monkeypatch.setattr(sweep_timing, "STREAM_SHAPES", ((70, 33), (41, 90)))
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc, lines = _run(sweep_timing.main, ["--device", "cpu", "--streams"])
    out = json.loads(lines[-1])
    assert rc == 0 and out["root"] == ROOT
    assert sorted(out["kernels"]) == sorted(
        f"{name} {M}x{W}" for M, W in ((70, 33), (41, 90))
        for name in ("stream_rmw", "stream_read", "stream_read_nan_skip"))
    for key, r in out["kernels"].items():
        assert r["ms"] is r["plain_ms"] is None
        assert r["library_ms"] is None
        M, W = (int(x) for x in key.split(" ")[1].split("x"))
        want = {"stream_rmw": 4 * M * W,
                "stream_read": 2 * M * W + 4 * (-(-M // 512) + W),
                "stream_read_nan_skip": 2 * M * W + 4 * W}[key.split(" ")[0]]
        assert r["bytes"] == want and r["bound_ms"] > 0
    assert len(lines) == 1 + len(out["kernels"])


def test_sweep_timing_row_sweep_on_cpu(monkeypatch, tmp_path):
    """``--row-sweep``: K2 at each panel of the two stairs (read from the
    Yahoo records), at the headline's panels and NAN_SHAPES, K2 fp8 and
    masked_usweep at f32, bf16 and fp8 beside both masks, each beside its
    plain version and its bound; a line a stair with 40 x its panels'
    times next to the record's profiled K2; times "not measured" on the
    CPU."""
    recs = tmp_path / "yahoo.jsonl"
    recs.write_text("".join(json.dumps(
        {"name": job, "panels": panels, "busy_ms_by_part": {"K2": k2}}) + "\n"
        for job, panels, k2 in (
            ("r1_t", [[0, 3, 700], [3, 40, 33]], 559.3),
            ("c15_t", [[0, 5, 301]], 329.5))))
    monkeypatch.setattr(sweep_timing, "ROW_RECORDS", str(recs))
    monkeypatch.setattr(sweep_timing, "HEADLINE_PANELS", ((70, 33),))
    monkeypatch.setattr(sweep_timing, "NAN_SHAPES", ((70, 33), (9, 301)))
    monkeypatch.setattr(sweep_timing, "MASKED_SHAPE", (40, 17))
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc, lines = _run(sweep_timing.main, ["--device", "cpu", "--row-sweep"])
    out = json.loads(lines[-1])
    assert rc == 0 and out["root"] == ROOT
    ks = out["kernels"]
    assert [k for k in ks if k.startswith("panel_usweep ")] == [
        "panel_usweep 3x700 bf16 r1_t panel 0",
        "panel_usweep 37x33 bf16 r1_t panel 1",
        "panel_usweep 5x301 bf16 c15_t panel 0",
        "panel_usweep 70x33 bf16", "panel_usweep 9x301 bf16"]
    assert "panel_usweep_fp8 70x33 fp8" in ks
    assert sorted(k.split(" ")[0] for k in ks
                  if k.startswith("masked_usweep")) == \
        ["masked_usweep"] * 4 + ["masked_usweep_fp8"] * 2
    for key, r in ks.items():
        if key.startswith("stair"):
            continue
        assert r["ms"] is None and r["plain_ms"] is None
        assert r["bound_ms"] == pytest.approx(1e3 * r["bytes"] / 3.35e12)
    assert ks["panel_usweep 3x700 bf16 r1_t panel 0"]["bytes"] == \
        2 * 3 * 700 + 4 * (700 + 6)
    stair = ks["stair r1_t"]
    assert stair["ms_per_iter"] is None
    assert stair["profiled_ms_per_iter"] == 559.3
    assert stair["bound_ms_per_iter"] == pytest.approx(40 * (
        ks["panel_usweep 3x700 bf16 r1_t panel 0"]["bound_ms"]
        + ks["panel_usweep 37x33 bf16 r1_t panel 1"]["bound_ms"]))
    assert sum(line.startswith("[stair]") for line in lines) == 2
    assert sum(line.startswith("[plan]") for line in lines) == 12


def test_sweep_timing_read_levers_on_cpu(monkeypatch):
    """``--read-levers``: both reads at each stream shape under
    stream_read's plan and under each plan that changes one lever of it
    (where it differs): the shifted path for an aligned panel, one wave,
    a 512-row block or 4 a thread block; times "not measured" on the
    CPU."""
    monkeypatch.setattr(sweep_timing, "STREAM_SHAPES",
                        ((1100, 264), (1041, 90)))
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc, lines = _run(sweep_timing.main, ["--device", "cpu", "--read-levers"])
    out = json.loads(lines[-1])
    assert rc == 0
    # (path, ranges) of each lever: 3 row blocks; the aligned 1100 x 264
    # takes one wave, the shifted 1041 x 90 a range of up to 4 row blocks
    want = {"1100x264": {"design": ("aligned", 3), "shifted": ("shifted", 1),
                         "4 row blocks": ("aligned", 1)},
            "1041x90": {"design": ("shifted", 1), "one wave": ("shifted", 3),
                        "1 row block": ("shifted", 3)}}
    assert sorted(out["kernels"]) == sorted(
        f"{mode} {shape} {lever}" for shape, levers in want.items()
        for lever in levers
        for mode in ("stream_read", "stream_read_nan_skip"))
    for key, r in out["kernels"].items():
        _, shape, lever = key.split(" ", 2)
        assert r["ms"] is None
        assert (r["path"], r["ranges"]) == want[shape][lever]
    assert len(lines) == 1 + len(out["kernels"])


def test_sweep_timing_gathers_on_cpu(monkeypatch):
    """``--gathers``: one line per gather form and shape (each against its
    plain version and its PyTorch call), bytes as the bound counts them,
    times "not measured" on the CPU."""
    monkeypatch.setattr(sweep_timing, "GATHER_SHAPES",
                        {"probe": (64, 16), "rows tail": (5, 7)})
    monkeypatch.setattr(sys, "path", list(sys.path))
    rc, lines = _run(sweep_timing.main, ["--device", "cpu", "--gathers"])
    out = json.loads(lines[-1])
    assert rc == 0 and out["root"] == ROOT
    assert sorted(out["kernels"]) == sorted(
        f"gather {f} {name} {S}x128, {rows} rows" for f in "ABC"
        for name, (S, rows) in (("probe", (64, 16)), ("rows tail", (5, 7))))
    for key, r in out["kernels"].items():
        assert r["ms"] is None and r["plain_ms"] is None
        assert r["library_ms"] is None and r["flops"] == 0
        S, rows = (64, 16) if "probe" in key else (5, 7)
        index = 4 * rows if key.startswith("gather C") else 4 * rows * 128
        assert r["bytes"] == index + 4 * rows * 128 + 4 * S * 128
    assert len(lines) == 1 + len(out["kernels"])


def test_sweep_timing_fp8_on_cpu(monkeypatch, tmp_path):
    """``--fp8``: one line per fp8 instance (K1 in both orders, K2, K3 on a
    NaN panel; K4 in both orders and the masked sweeps beside each mask);
    ``--outputs`` writes the digests of (R', g, h) on the seeded input,
    holds a second run bit-equal to them and exits 1 on a digest that
    differs."""
    monkeypatch.setattr(sweep_timing, "NAN_SHAPES", ((70, 33),))
    monkeypatch.setattr(sweep_timing, "MASKED_SHAPE", (40, 17))
    monkeypatch.setattr(sweep_timing, "FP8_OUTPUT_SHAPE", (131, 37))
    monkeypatch.setattr(sys, "path", list(sys.path))
    path = str(tmp_path / "outputs.json")
    argv = ["--device", "cpu", "--fp8", "--outputs", path]
    rc, lines = _run(sweep_timing.main, argv)
    out = json.loads(lines[-1])
    assert rc == 0 and out["outputs_differ"] == []
    names = sorted(k.split(" ")[0] for k in out["kernels"])
    want = ["panel_update_vsweep_fp8", "panel_update_vsweep_fp8_delta_first",
            "panel_usweep_fp8", "panel_vsweep_fp8"] + 2 * [
        "fused_update_vsweep_fp8", "fused_update_vsweep_fp8_delta_first",
        "masked_usweep_fp8", "masked_vsweep_fp8"]
    assert names == sorted(want)
    for r in out["kernels"].values():
        assert r["ms"] is None and r["bytes"] > 0 and r["flops"] > 0
    with open(path) as f:
        digests = json.load(f)
    assert len(digests) == 12 and "masked_usweep_fp8 int8" in digests
    rc, _ = _run(sweep_timing.main, argv)
    assert rc == 0
    digests["panel_vsweep_fp8 nan"] = "0" * 64
    with open(path, "w") as f:
        json.dump(digests, f)
    rc, lines = _run(sweep_timing.main, argv)
    assert rc == 1
    assert json.loads(lines[-1])["outputs_differ"] == ["panel_vsweep_fp8 nan"]


def test_fp8_runs_needs_the_card(monkeypatch, capsys, tmp_path):
    """scripts/fp8_runs.py (phases 43-44's fp8 runs for one checkout)
    exits 2 without a card and prints no result; a process that holds the
    package from another checkout refuses."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    assert fp8_runs.main([]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    (tmp_path / "chip_smoke.py").write_text("")
    real = sys.modules.pop("chip_smoke", None)
    try:
        with pytest.raises(RuntimeError, match="fresh process"):
            fp8_runs.main(["--root", str(tmp_path)])
    finally:
        sys.modules.pop("chip_smoke", None)
        if real is not None:
            sys.modules["chip_smoke"] = real


def test_sweep_timing_refuses_a_package_from_elsewhere(monkeypatch,
                                                       tmp_path):
    """--root names the checkout to time; a process that already holds the
    package from another one refuses rather than time the wrong kernels."""
    monkeypatch.setattr(sys, "path", list(sys.path))
    with pytest.raises(RuntimeError, match="fresh process"):
        sweep_timing.main(["--root", str(tmp_path), "--device", "cpu"])


def test_profile_iteration_script_on_cpu(monkeypatch):
    """Every configuration runs one traced outer iteration; on the CPU no
    device kernel is traced and the idle share is not measured."""
    monkeypatch.setattr(profile_iteration, "DENSE",
                        dict(m=300, n=120, nnz=6000, k=4, lam=0.1))
    monkeypatch.setattr(profile_iteration, "ALS",
                        dict(m=300, n=120, nnz=6000, k=6, lam=0.1))
    monkeypatch.setattr(profile_iteration, "HYBRID_ARGS",
                        TINY[:8] + ["--panel-widths", "32,16"])
    rc, lines = _run(profile_iteration.main, ["--device", "cpu"])
    recs = [json.loads(x) for x in lines if x.startswith("{")]
    assert rc == 0 and [r["config"] for r in recs] == ["hybrid", "dense",
                                                       "als"]
    for r in recs:
        assert r["kernels"] == [] and r["idle_pct"] is None
        assert r["wall_ms"] > 0 and r["device"]["platform"] == "cpu"


def test_variant_pattern_panel():
    R = panel_kernel_variants.pattern_panel(50, 90, "cpu")
    r, c = np.meshgrid(np.arange(50), np.arange(90), indexing="ij")
    obs = (r * 7 + c * 13) % 41 == 0
    x = R.float().numpy()
    assert np.array_equal(~np.isnan(x), obs) and np.all(x[obs] == 1.0)


def test_gather_script_on_cpu():
    rc, lines = _run(probe_gather.main, ["--device", "cpu", "--tail",
                                         "5000:121:3"])
    recs = [json.loads(x) for x in lines]
    assert rc == 0 and recs[0]["case"] == "probe"
    assert recs[1]["table_rows"] == 3 and recs[1]["index_rows"] == 40
    assert probe_gather.tail_shape(2_969_000, 480_190, 2) == (7503, 23196)


def test_bench_reads_the_runs_own_orientation(monkeypatch):
    """The bench plans through ccd_hybrid_train's own orientation branch,
    once, and reports the plan that run chose."""
    calls = []
    real = ch.plan_oriented
    monkeypatch.setattr(ch, "plan_oriented",
                        lambda R, cfg: calls.append(1) or real(R, cfg))
    rec = _bench(["--panel-widths", "32,16", "--transpose", "1"])
    d = rec["detail"]
    assert len(calls) == 1
    assert d["orientation"] == "transposed (items as rows)"
    R, _ = datasets.synthetic_cached(300, 120, 6000, seed=1,
                                     test_fraction=0.02)
    cfg = Config(backend="hybrid", hybrid_dense_cells=12000,
                 hybrid_panel_widths=(32, 16), mask_dtype="nan")
    plan = ch.plan_hybrid(R.transpose(), cfg, materialize_dense=False)
    assert d["panels"] == [list(p) for p in plan.panels]
    assert d["tail"]["rows"]["table_rows"] == R.rows + 1   # users' table


def test_launches_untouched_on_cpu():
    launches.reset_launch_counts()
    _bench()
    assert set(launches.launch_counts().values()) == {0}
