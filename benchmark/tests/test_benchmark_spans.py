"""The program's spans in a trace (``benchmark/spans.py``): the span
reduction on synthetic tuples, the tuples of a CPU profile, the figures
on reductions recorded from traced runs on the card
(``data/spans_*.json``), and on the card that the spans put nothing on
the device's timeline."""

import json
import os

import pytest

from benchmark import spans as sp, trace as tracing

DATA = os.path.join(os.path.dirname(__file__), "data")

#: one step (its panels, its tail), the RMSE and the loop's fence on
#: thread 1; nothing on thread 2
SPANS = [("crtpu.step", 0.0, 100.0, 1), ("crtpu.ccd.panels", 10.0, 40.0, 1),
         ("crtpu.ccd.tail", 50.0, 80.0, 1), ("crtpu.eval.rmse", 100.0, 110.0, 1),
         ("crtpu.loop.sync", 110.0, 200.0, 1)]
LAUNCHES = {1: (15.0, 1), 2: (20.0, 1), 3: (45.0, 1), 4: (55.0, 1),
            5: (105.0, 1), 6: (210.0, 1), 7: (15.0, 2), 9: (230.0, 1)}
OPS = [("K1", 20.0, 60.0, 1), ("K2", 60.0, 90.0, 2), ("zero", 90.0, 92.0, 3),
       ("tail", 100.0, 110.0, 4), ("thread2", 110.0, 111.0, 7),
       ("rmse", 130.0, 140.0, 5), ("late", 215.0, 220.0, 6),
       ("lost", 220.0, 222.0, 8), ("after", 300.0, 301.0, 9)]


def _reduced():
    return sp.reduce_spans(OPS, LAUNCHES, SPANS, window_s=400e-6,
                           iterations=1)


def test_operations_go_to_the_span_that_launched_them():
    r = _reduced()
    s = r["spans"]
    assert s["crtpu.ccd.panels"]["device_self_s"] == pytest.approx(70e-6)
    assert s["crtpu.ccd.panels"]["kernels"] == pytest.approx(
        {"K1": 40e-6, "K2": 30e-6})
    assert s["crtpu.ccd.tail"]["device_s"] == pytest.approx(10e-6)
    assert s["crtpu.eval.rmse"]["device_s"] == pytest.approx(10e-6)
    assert s["crtpu.loop.sync"]["device_s"] == 0.0
    # launched on a thread without spans, outside every span, or with no
    # launch in the trace
    assert r["unattributed_s"] == pytest.approx((1 + 5 + 2 + 1) * 1e-6)
    assert r["device_s"] == pytest.approx(101e-6) and r["launches"] == 9


def test_inclusive_and_self_figures():
    step = _reduced()["spans"]["crtpu.step"]
    assert step["count"] == 1
    assert step["device_s"] == pytest.approx(82e-6)
    assert step["device_self_s"] == pytest.approx(2e-6)
    assert (step["launches"], step["launches_self"]) == (4, 1)
    assert step["host_s"] == pytest.approx(100e-6)
    assert step["host_self_s"] == pytest.approx(40e-6)
    assert step["kernels"] == pytest.approx({"zero": 2e-6})


def test_idle_gaps_go_to_the_innermost_span_at_their_midpoint():
    r = _reduced()
    assert r["busy_s"] == pytest.approx((72 + 11 + 10 + 7 + 1) * 1e-6)
    # 92 -> 100 in the step's own time; 111 -> 130 and 140 -> 215 in the
    # fence; 222 -> 300 in no span
    assert dict(r["idle_by_span"]) == pytest.approx(
        {"crtpu.step": 8e-6, "crtpu.loop.sync": 94e-6, sp.OUTSIDE: 78e-6})
    assert r["idle_s"] == pytest.approx(180e-6)
    assert r["spans"]["crtpu.step"]["idle_s"] == pytest.approx(8e-6)
    m = sp.span_metrics(r)
    assert m == pytest.approx({
        "ell_tail_ms": 0.01, "rmse_ms": 0.01, "gather_ms": None,
        "gram_ms": None, "dispatch_idle_pct": 100 * 8 / 400,
        "step_launches": 4})


def test_idle_inside_a_nested_span_counts_for_its_parents():
    spans = [("crtpu.step", 0.0, 100.0, 1), ("crtpu.als.gram", 10.0, 50.0, 1)]
    ops = [("a", 5.0, 20.0, 1), ("b", 30.0, 40.0, 2), ("c", 70.0, 80.0, 3)]
    launches = {1: (2.0, 1), 2: (12.0, 1), 3: (65.0, 1)}
    r = sp.reduce_spans(ops, launches, spans, 100e-6, 2)
    gram, step = r["spans"]["crtpu.als.gram"], r["spans"]["crtpu.step"]
    assert gram["idle_self_s"] == pytest.approx(10e-6)          # 20 -> 30
    assert step["idle_self_s"] == pytest.approx(30e-6)          # 40 -> 70
    assert step["idle_s"] == pytest.approx(40e-6)
    assert sp.span_metrics(r)["gram_ms"] == pytest.approx(1e3 * 10e-6 / 2)
    assert sp.span_metrics(r)["step_launches"] == 1.5


def test_a_span_cut_by_the_profiler_s_stop_ends_with_its_parent():
    spans = [("crtpu.loop.sync", 0.0, 50.0, 1),
             ("crtpu.loop.callback", 40.0, 90.0, 1)]
    ops = [("k", 60.0, 70.0, 1)]
    r = sp.reduce_spans(ops, {1: (45.0, 1)}, spans, 100e-6, 1)
    cb = r["spans"]["crtpu.loop.callback"]
    assert cb["device_s"] == pytest.approx(10e-6)
    assert cb["host_s"] == pytest.approx(10e-6)
    assert r["spans"]["crtpu.loop.sync"]["device_s"] == pytest.approx(10e-6)
    nest = sp._Nest(spans)
    assert nest.innermost(45.0) == 1 and nest.innermost(55.0) == -1


def test_nothing_to_read_without_spans():
    r = sp.reduce_spans([("k", 0.0, 1.0, 1)], {}, [], 1e-6, 1)
    assert r["spans"] == {} and r["unattributed_s"] == pytest.approx(1e-6)
    assert set(sp.span_metrics(r).values()) == {None}


def test_tuples_of_a_cpu_profile():
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuda_recommender_tpu_torch.utils.timing import span

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("crtpu.step"):
            with span("crtpu.als.gram"):
                torch.ones(8) * 2
    ops, launches, spans = sp.profile_tuples(prof)
    assert ops == [] and launches == {}
    assert [s[0] for s in sorted(spans, key=lambda s: s[1])] == [
        "crtpu.step", "crtpu.als.gram"]
    (_, a0, b0, t0), (_, a1, b1, t1) = sorted(spans, key=lambda s: s[1])
    assert 0 <= a0 <= a1 <= b1 <= b0 and t0 == t1


def _recorded():
    return sorted(f for f in os.listdir(DATA) if f.startswith("spans_"))


def test_recorded_runs_are_of_the_benchmark_s_cells():
    from benchmark import spec

    cells = {f"spans_{w['name']}.json" for w in spec.load_spec()["workloads"]}
    assert _recorded() and set(_recorded()) <= cells


@pytest.mark.parametrize("name", _recorded())
def test_figures_of_a_recorded_traced_run(name):
    """A traced run on the card: the spans attribute nearly all device
    time, the figures stay within what the outside-in metrics of the same
    window read, and each layer's kernels lie in their span."""
    with open(os.path.join(DATA, name)) as f:
        rec = json.load(f)
    red, lay, old = rec["spans"], rec["layers_by_span"], rec["metrics"]
    m = sp.span_metrics(red)
    assert m == pytest.approx(rec["span_metrics"])
    assert red["unattributed_s"] < 0.005 * red["busy_s"]
    assert red["busy_s"] == pytest.approx(rec["trace_busy_s"], rel=1e-6)
    assert 0 < m["dispatch_idle_pct"] <= old["device_idle_pct"]
    assert m["step_launches"] == int(m["step_launches"])
    if "tail_ms" in old:                                # CCD++
        assert m["ell_tail_ms"] + m["rmse_ms"] <= old["tail_ms"]
        k12 = {**lay["K1"], **lay["K2"]}
        assert set(k12) == {"crtpu.ccd.panels"}
        panels = red["spans"]["crtpu.ccd.panels"]["device_s"]
        k12_s = sum(lay["K1"].values()) + sum(lay["K2"].values())
        assert k12_s <= panels <= 1.005 * k12_s
    else:                                               # ALS
        assert set(lay["K5"]) == {"crtpu.als.solve"}
        assert set(lay["bmm"]) == {"crtpu.als.gram"}
        bmm_ms = 1e3 * lay["bmm"]["crtpu.als.gram"] / red["iterations"]
        assert m["gram_ms"] == pytest.approx(bmm_ms, rel=0.01)
        assert m["gather_ms"] + m["gram_ms"] + m["rmse_ms"] <= \
            1e3 * red["device_s"] / red["iterations"] - old["k5_ms"]


@pytest.mark.card
def test_program_spans_put_nothing_on_the_device_timeline(card_device):
    """Under the benchmark's own profiler the program's spans are neither
    kernels nor busy time of ``trace.reduce_profile``; the span reduction
    sees the same busy time and puts the product in its span."""
    import torch

    from cuda_recommender_tpu_torch.utils.timing import span

    x = torch.randn(512, 512, device=card_device)
    for _ in range(3):
        x @ x
    torch.cuda.synchronize(card_device)
    with tracing.profiler() as prof:
        with span("crtpu.step", {"oiter": 1}):
            with span("crtpu.als.gram"):
                y = x @ x
            y.sum()
        torch.cuda.synchronize(card_device)
    red = tracing.reduce_profile(prof, 1.0, 1)
    assert red["kernels"] and not any(
        name.startswith(sp.PREFIX) for name, _, _ in red["kernels"])
    r = sp.reduce_spans(*sp.profile_tuples(prof), 1.0, 1)
    assert r["busy_s"] == pytest.approx(red["busy_s"], rel=1e-6)
    assert r["device_s"] == pytest.approx(
        sum(s for _, s, _ in red["kernels"]), rel=1e-6)
    assert r["unattributed_s"] == 0.0
    gram = r["spans"]["crtpu.als.gram"]
    assert gram["launches_self"] >= 1 and all(
        tracing.LAYER_PATTERNS["bmm"].search(k) for k in gram["kernels"])
    assert r["spans"]["crtpu.step"]["launches"] > gram["launches"]
