"""The harness is driven by data: a new mix, metric and cell are new files
and entries, found by name; a run without a card fails."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark import cell as cellmod, spec, trace as tracing

from .conftest import ROOT

DATA = os.path.join(os.path.dirname(__file__), "data")
#: a small mix: the hybrid plans two panels and an ELL tail at this size
SMALL = dict(rows=700, cols=300, train_nnz=20_000, test_share=0.02,
             structure_seed=1,
             user_zipf=0.8, item_zipf=0.9, truth_rank=8, noise=0.1,
             offset=3.5,
             plan={"ccd": {"hybrid_dense_cells": 60_000,
                           "hybrid_panel_widths": [64, 32],
                           "hybrid_transpose": False}})


def recorded(name: str) -> dict:
    """A trace reduction recorded from a traced run on the card."""
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture
def extended(tmp_path):
    """A copy of the benchmark with a dummy mix, a dummy metric and a cell
    naming them added as new files and entries; no existing file edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p: (tmp_path / "benchmark" / p).read_bytes()
              for p in ("run.py", "cell.py", "spec.py", "trace.py")}
    s = spec.load_spec()
    s["workloads"].append({"name": "ccd.dummy", "config": "ccd_k40_bf16_nan",
                           "traffic": "dummy", "chips": 1,
                           "why": "a dummy cell of the data-driven test"})
    s["per_layer"].append({"name": "dummy_ms", "unit": "ms",
                           "better": "lower", "source": "device_trace",
                           "layer": "dummy", "moves": "iter_s",
                           "workloads": ["ccd.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    (tmp_path / "benchmark" / "traffic" / "dummy.json").write_text(
        json.dumps(dict(SMALL, name="dummy")))
    (tmp_path / "benchmark" / "metrics" / "dummy_ms.py").write_text(
        textwrap.dedent('''
            LAYER = "dummy"
            UNIT = "ms"
            SOURCE = "device_trace"
            MOVES = "iter_s"

            def read(ctx):
                tr = ctx.trace
                if not tr:
                    return None
                return 1e3 * tr["busy_s"] / tr["iterations"]
        '''))
    yield tmp_path
    for p, b in before.items():
        assert (tmp_path / "benchmark" / p).read_bytes() == b


def test_new_cell_mix_and_metric_resolve_by_name(extended):
    bench = str(extended / "benchmark")
    c = spec.resolve(spec.load_spec(str(extended)), "ccd.dummy",
                     root=str(extended), bench_dir=bench)
    assert c.traffic["rows"] == SMALL["rows"]
    assert c.config["name"] == "ccd_k40_bf16_nan"
    names = [m["name"] for m in c.per_layer]
    assert "dummy_ms" in names and "k5_ms" not in names
    reader = spec.metric_reader("dummy_ms", bench_dir=bench)
    tr = recorded("trace_ccd_netflix")
    ctx = cellmod.MetricContext(
        solver="ccd", k=40, rows=480189, cols=17770, nnz=100_000_000,
        residual_dtype="bfloat16", als_precision="highest",
        panels=tr["panels"], plan_events=[], trace=tr)
    assert reader.read(ctx) == pytest.approx(
        1e3 * tr["busy_s"] / tr["iterations"])
    ctx.trace = None
    assert reader.read(ctx) is None


def test_new_cell_runs_on_the_cpu(extended):
    bench = str(extended / "benchmark")
    c = spec.resolve(spec.load_spec(str(extended)), "ccd.dummy",
                     root=str(extended), bench_dir=bench)
    out = cellmod.run_cell(c, 2 ** 31 + 3, 0.05, torch.device("cpu"))
    assert out.iters >= 1 and sorted(out.rmse) == list(
        range(1, out.iters + 3))
    assert out.failed == 0 and out.setup_s > 0 and out.window_s > 0
    assert out.context.panels and out.context.plan_events
    assert set(out.readings) <= set(cellmod.READINGS)
    assert out.readings["rmse_gap"] < 0.01


def test_no_card_fails_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "ccd.netflix", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_unknown_workload_raises():
    with pytest.raises(KeyError):
        spec.resolve(spec.load_spec(), "no.such")


def test_breakdown_of_recorded_trace():
    tr = recorded("trace_ccd_netflix")
    b = tracing.breakdown(tr)
    assert len(b["device_ops"]) <= tracing.TOP
    assert len(b["idle_gaps"]) <= tracing.TOP
    assert b["device_ops"][0][1] >= b["device_ops"][-1][1]
