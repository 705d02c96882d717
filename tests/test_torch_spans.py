"""The port's profiler spans (``utils/timing.py::span``) and the pipelined
loop's timers, on the CPU: the helper off and on, a span that outlives the
profiler, every ``crtpu.*`` span of a tiny hybrid CCD++ and a tiny ALS run
nested and counted as the plan says, and ``IterStats.rmse_time``."""

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cuda_recommender_tpu_torch.core.config import Config
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.ell import build_ell_pair
from cuda_recommender_tpu_torch.solvers import als_ell, ccd_hybrid
from cuda_recommender_tpu_torch.solvers.pipeline import pipelined_loop
from cuda_recommender_tpu_torch.utils import timing

K = 4
ITERS = 3


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(prof) -> dict:
    """{span name: [the names of its enclosing crtpu spans, innermost
    first], one list per occurrence}."""
    out: dict = {}
    for e in prof.events():
        if not e.name.startswith("crtpu."):
            continue
        chain, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("crtpu."):
                chain.append(p.name)
            p = p.cpu_parent
        out.setdefault(e.name, []).append(chain)
    return out


@pytest.fixture(scope="module")
def data():
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


def test_span_off_is_the_shared_null_context(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a record-function range with no profiler")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    a, b = timing.span("crtpu.a"), timing.span("crtpu.b", {"oiter": 1})
    assert a is b and isinstance(a, contextlib.nullcontext)
    with timing.span("crtpu.a"):
        pass


def test_span_on_is_a_function_range_in_the_trace():
    x = torch.randn(32, 32)
    with _cpu_profile() as prof:
        with timing.span("crtpu.outer", {"oiter": 7}):
            with timing.span("crtpu.inner"):
                x @ x
    spans = _spans(prof)
    assert spans == {"crtpu.outer": [[]], "crtpu.inner": [["crtpu.outer"]]}
    ev = {e.name: e for e in prof.events()}
    # not a user annotation: the profiler then puts no annotation of the
    # span on the device's timeline, where a trace's readers take every
    # device event for a kernel
    assert not ev["crtpu.outer"].is_user_annotation
    assert ev["aten::mm"].cpu_parent.name == "aten::matmul"
    assert ev["aten::matmul"].cpu_parent.name == "crtpu.inner"


def test_span_outlives_the_profiler():
    """Entered while a profiler runs and closed after it stops (the
    benchmark stops its profiler inside the loop's callback), and the
    other way round: neither raises."""
    prof = _cpu_profile()
    prof.__enter__()
    s = timing.span("crtpu.loop.callback")
    s.__enter__()
    prof.__exit__(None, None, None)
    s.__exit__(None, None, None)
    s = timing.span("crtpu.loop.callback")
    with _cpu_profile():
        s.__enter__()
        s.__exit__(None, None, None)
    with timing.span("crtpu.loop.callback"):
        with _cpu_profile():
            pass


def _loop_spans(spans: dict, ckpts: int) -> None:
    """The loop's own spans over ITERS iterations with one callback each
    and ``ckpts`` checkpoints: none inside another crtpu span, and the
    RMSE outside the step."""
    assert spans["crtpu.step"] == [[]] * ITERS
    assert spans["crtpu.eval.rmse"] == [[]] * ITERS
    assert spans["crtpu.loop.sync"] == [[]] * ITERS
    assert spans["crtpu.loop.callback"] == [[]] * ITERS
    assert spans.get("crtpu.loop.checkpoint", []) == [[]] * ckpts


@pytest.mark.parametrize("defer_group", [0, 3])
def test_hybrid_spans_follow_the_plan(data, defer_group):
    R, T = data
    cfg = Config(k=K, lambda_=0.1, maxiter=ITERS, backend="hybrid",
                 mask_dtype="nan", hybrid_panel_kernel=True,
                 hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16),
                 hybrid_defer_group=defer_group)
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    seen, run = [], {}
    with _cpu_profile() as prof:
        ccd_hybrid.ccd_hybrid_train(R, W0, H0, T, cfg, device="cpu",
                                    callback=seen.append, run=run,
                                    ckpt_every=2, ckpt_fn=lambda o, p: None)
    plan = run["plan"]
    assert len(plan.panels) >= 2 and plan.nnz_light > 0
    spans = _spans(prof)
    _loop_spans(spans, ckpts=1)
    # k ranks x 2 half-sweeps of panels and of tail an iteration, all in
    # the step; the deferred tail adds a flush every G ranks and at the last
    assert spans["crtpu.ccd.panels"] == [["crtpu.step"]] * (K * 2 * ITERS)
    flushes = -(-K // defer_group) if defer_group else 0
    assert spans["crtpu.ccd.tail"] == [["crtpu.step"]] * (
        (K * 2 + flushes) * ITERS)
    assert len(seen) == ITERS


def test_pure_ell_hybrid_has_no_panel_work(data):
    R, T = data
    cfg = Config(k=K, lambda_=0.1, maxiter=ITERS, backend="hybrid",
                 mask_dtype="nan", hybrid_panel_kernel=True,
                 hybrid_dense_cells=0, hybrid_panel_widths=())
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    with _cpu_profile() as prof:
        ccd_hybrid.ccd_hybrid_train(R, W0, H0, T, cfg, device="cpu",
                                    callback=lambda st: None)
    spans = _spans(prof)
    _loop_spans(spans, ckpts=0)
    assert spans["crtpu.ccd.tail"] == [["crtpu.step"]] * (K * 2 * ITERS)
    ev = [e for e in prof.events() if e.name == "crtpu.ccd.panels"]
    assert len(ev) == K * 2 * ITERS and all(not e.cpu_children for e in ev)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_als_spans_follow_the_plan(data, precision):
    R, T = data
    cfg = Config(solver="als", k=K, maxiter=ITERS, lambda_=0.1,
                 backend="ell", als_precision=precision)
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0, entity_major=True)
    with _cpu_profile() as prof:
        als_ell.als_ell_train(R, W0, H0, T, cfg, device="cpu",
                              callback=lambda st: None)
    ell = build_ell_pair(R, min_width=cfg.als_min_width, num_shards=1)
    groups = als_ell.k5_launches_per_iter(ell, K, "gj",
                                          cfg.als_group_mb << 20, precision)
    assert groups >= 4
    spans = _spans(prof)
    _loop_spans(spans, ckpts=0)
    # one gather of the tables a side, and a gram and solve a (side,
    # bucket, row group); the bf16 grams gather a group's operands first,
    # "highest" (als_gram) gathers nothing apart
    step = [["crtpu.step"]]
    gathers = 2 + (0 if precision == "highest" else groups)
    assert spans["crtpu.als.gather"] == step * (gathers * ITERS)
    assert spans["crtpu.als.gram"] == step * (groups * ITERS)
    assert spans["crtpu.als.solve"] == step * (groups * ITERS)
    gram = [e for e in prof.events() if e.name == "crtpu.als.gram"][0]
    bmms = [c for c in gram.cpu_children if c.name == "aten::bmm"]
    assert len(bmms) == (3 if precision == "high" else 1)


@pytest.mark.parametrize("fuse", [1, 2])
def test_rmse_time_is_the_rmse_s_own_time(fuse):
    """``rmse_time`` times ``do_rmse`` itself (on the CPU its host clock),
    not the readback after the fence; ``rank_time`` is still the group's
    wall time from its start to its fence, over its iterations."""
    def do_step():
        time.sleep(0.02)
        return torch.zeros(1)

    def do_rmse():
        time.sleep(0.01)
        return torch.tensor(1.5)

    t0 = time.perf_counter()
    stats = pipelined_loop(start_oiter=1, maxiter=4, fuse=fuse,
                           do_step=do_step, do_rmse=do_rmse)
    wall = time.perf_counter() - t0
    assert [st.oiter for st in stats] == [1, 2, 3, 4]
    assert all(st.rmse == 1.5 for st in stats)
    assert all(0.01 <= st.rmse_time < st.rank_time for st in stats)
    assert all(st.rank_time >= 0.03 for st in stats)
    assert sum(st.rank_time for st in stats) == pytest.approx(wall, rel=0.05)
    assert np.isclose(stats[0].rank_time, stats[fuse - 1].rank_time)
