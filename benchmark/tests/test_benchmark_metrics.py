"""The yardstick's arithmetic: the peaks and least-work functions, the
trace reduction, and every per-layer reader on profiles recorded from
traced runs on the card (``data/trace_*.json``: the reduction a traced run
prints, with the run's stair)."""

import json
import os

import pytest

from benchmark import cell as cellmod, peaks, spec, trace as tracing

DATA = os.path.join(os.path.dirname(__file__), "data")
NETFLIX_PANELS = [[0, 330128, 17770], [330128, 480189, 4096]]


def recorded(name):
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return json.load(f)


def test_ccd_step_bytes_is_the_issue_s_16_7_ms():
    b = peaks.ccd_step_bytes(100_000_000, 40, "bfloat16")
    assert b == 40 * 100_000_000 * (3 * 2 + 2 * 4)
    assert 1e3 * b / peaks.PEAK_BYTES_S == pytest.approx(16.716, abs=1e-3)


def test_assembly_bound_matches_the_port_s_record():
    # PERF.md, ALS headline: 2.007 ms (operations) at ml20M, "highest";
    # 0.475 ms (bytes) at "high" and "default"
    ms, by = peaks.assembly_bound(20_000_000, 138_493 + 26_744, 40, "highest")
    assert (round(ms, 3), by) == (2.007, "operations")
    ms, by = peaks.assembly_bound(20_000_000, 138_493 + 26_744, 40, "default")
    assert (round(ms, 3), by) == (0.475, "bytes")


def test_assembly_bound_is_the_port_s_copy():
    from cuda_recommender_tpu_torch.scripts.common import assembly_bound

    for args in ((20_000_000, 165_237, 40, "highest"),
                 (115_000_000, 2_047_094, 40, "high"),
                 (1000, 30, 128, "default")):
        assert peaks.assembly_bound(*args) == assembly_bound(*args)


def test_als_step_flops():
    k, nnz, m, n = 40, 20_000_000, 138_493, 26_744
    f = peaks.als_step_flops(nnz, m, n, k)
    assert f == 2 * nnz * 2 * 41 ** 2 + (m + n) * (2 * 40 ** 3 / 3 + 2 * 1600)
    assert 1e3 * f / peaks.PEAK_F32_FLOP_S == pytest.approx(2.1203, abs=1e-3)


def test_panel_bytes_of_the_netflix_stair():
    cells = 330128 * 17770 + 150061 * 4096
    assert peaks.panel_bytes(NETFLIX_PANELS, 40, "bfloat16") == 40 * cells * 6
    assert peaks.panel_bytes(NETFLIX_PANELS, 1, "float8_e4m3fn") == cells * 3


def test_reduce_events_union_and_gaps():
    kernels = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k1", 20.0, 30.0),
               ("k3", 40.0, 41.0)]
    cpu = [(0.0, 50.0, "outer"), (11.0, 25.0, "aten::index"),
           (35.0, 39.0, "cudaDeviceSynchronize")]
    tr = tracing.reduce_events(kernels, cpu, window_s=60e-6, iterations=2)
    assert tr["busy_s"] == pytest.approx(23e-6)
    assert tr["kernels"][0][0] == "k1" and tr["kernels"][0][2] == 2
    assert tr["kernels"][0][1] == pytest.approx(20e-6)
    gaps = dict(tr["idle_gaps"])
    assert gaps["aten::index"] == pytest.approx(8e-6)             # 12 -> 20
    assert gaps["cudaDeviceSynchronize"] == pytest.approx(10e-6)  # 30 -> 40
    assert tracing.layer_seconds(tr, "K1") == 0.0


def _ctx(solver, tr, **kw):
    base = dict(k=40, residual_dtype="bfloat16", als_precision="highest",
                panels=None, plan_events=[{"plan_s": 8.5, "setup_s": 3.0},
                                          {"plan_s": 0.0, "setup_s": 2.5}])
    if solver == "ccd":
        base.update(rows=480_189, cols=17_770, nnz=100_000_000,
                    panels=(tr or {}).get("panels"))
    else:
        base.update(rows=138_493, cols=26_744, nnz=20_000_000)
    base.update(kw)
    base.setdefault("trace", tr)
    return cellmod.MetricContext(solver=solver, **base)


def _readers(workload):
    return {m["name"]: spec.metric_reader(m["name"])
            for m in spec.load_spec()["per_layer"]
            if workload in m["workloads"]}


def test_readers_state_what_benchmark_json_says():
    for m in spec.load_spec()["per_layer"]:
        mod = spec.metric_reader(m["name"])
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["source"], m["moves"])


def test_ccd_readers_on_a_recorded_profile():
    tr = recorded("trace_ccd_netflix")
    r = {name: mod.read(_ctx("ccd", tr)) for name, mod in
         _readers("ccd.netflix").items()}
    per_iter = tr["window_s"] / tr["iterations"]
    assert r["plan_s"] == 8.5 and r["device_setup_s"] == 5.5
    assert r["step_mfu"] == pytest.approx(
        100 * 5.6e10 / 3.35e12 / per_iter)
    k12 = (tracing.layer_seconds(tr, "K1") + tracing.layer_seconds(tr, "K2"))
    assert r["panel_roofline_pct"] == pytest.approx(
        100 * peaks.panel_bytes(tr["panels"], 40, "bfloat16")
        * tr["iterations"] / 3.35e12 / k12)
    assert 0 < r["panel_roofline_pct"] < 100
    total = sum(s for _, s, _ in tr["kernels"])
    assert r["tail_ms"] == pytest.approx(1e3 * (total - k12)
                                         / tr["iterations"])
    assert r["device_idle_pct"] == pytest.approx(
        100 * (1 - tr["busy_s"] / tr["window_s"]))
    # a CCD++ profile has no K5 and no ALS assembly to read
    als = _readers("als.ml20m")
    assert als["k5_ms"].read(_ctx("ccd", tr)) is None
    assert als["assembly_roofline_pct"].read(_ctx("ccd", tr)) is None


def test_als_readers_on_a_recorded_profile():
    tr = recorded("trace_als_ml20m")
    r = {name: mod.read(_ctx("als", tr)) for name, mod in
         _readers("als.ml20m").items()}
    k5 = tracing.layer_seconds(tr, "K5")
    assert r["k5_ms"] == pytest.approx(1e3 * k5 / tr["iterations"])
    total = sum(s for _, s, _ in tr["kernels"])
    bound, _ = peaks.assembly_bound(20_000_000, 138_493 + 26_744, 40,
                                    "highest")
    assert r["assembly_roofline_pct"] == pytest.approx(
        100 * bound / (1e3 * (total - k5) / tr["iterations"]))
    least = peaks.als_step_flops(20_000_000, 138_493, 26_744, 40) / 67e12
    assert r["step_mfu"] == pytest.approx(
        100 * least / (tr["window_s"] / tr["iterations"]))
    assert 0 < r["step_mfu"] < 100 and 0 < r["assembly_roofline_pct"] < 100
    ccd = _readers("ccd.netflix")
    assert ccd["panel_roofline_pct"].read(_ctx("als", tr)) is None
    assert ccd["tail_ms"].read(_ctx("als", tr)) is None


@pytest.mark.parametrize("name", ["step_mfu", "panel_roofline_pct", "tail_ms",
                                  "assembly_roofline_pct", "k5_ms",
                                  "device_idle_pct", "plan_s",
                                  "device_setup_s"])
def test_readers_find_nothing_without_a_trace(name):
    ctx = _ctx("ccd", {}, trace=None, plan_events=[])
    assert spec.metric_reader(name).read(ctx) is None
