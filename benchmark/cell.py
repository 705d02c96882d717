"""One run of one cell: the data from the seed, the program's set-up and
warm-up, the measured window, the traced window's reduction, and the
comparison with the plain reference that decides ``correct``.

The window drives the port's compiled training path, the solver that
``core/trainer.py::solve`` dispatches to (``ccd_hybrid_train``,
``als_ell_train``), and reads it through the entry's per-iteration
``callback``; the harness writes no step or loop of its own. The entry
takes its iteration count up front, so a run calls it twice:

1. set-up: ``WARM_ITERS`` iterations from the initial factors, which build
   (in a checkout's first run) and warm every kernel at the cell's shapes
   and time an iteration; the hybrid's plan is kept from this call;
2. the window's call: the entry again from the same initial factors, with
   the plan passed in, for N + 2 iterations, N = ceil(seconds / that
   iteration's time). Iteration 1 is set-up too. The window runs from the
   callback of iteration 1 to that of iteration N + 1: N whole iterations,
   each with its on-device test RMSE, each ending in
   ``torch.cuda.synchronize()``. Iteration N + 2 follows the window: it is
   the step that the ``step`` check follows from the program's own state,
   which the entry's checkpoint hook hands over after iteration N + 1,
   outside the window.

Afterwards, with the program's state freed, the configuration's plain
reference works the same ratings again (``check`` in its file):

* ``trajectory`` (CCD++): all N + 2 iterations from the initial factors;
* ``step`` (ALS, whose trajectories part at float32 round-off over
  hundreds of iterations): the first ``WARM_ITERS`` iterations from the
  initial factors, and iteration N + 2 from the program's state after
  iteration N + 1.

The readings (``READINGS``) are compared with the cell's limits.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import datagen, faults, spec, trace as tracing

#: outer iterations of the set-up's first call of the entry
WARM_ITERS = 2
#: host seconds of the window's end that a traced run traces (at least one
#: iteration): the profiler's reduction of a whole window of a CCD++ cell
#: takes minutes
TRACE_SECONDS = 2.0
#: what the comparison reads, each against the reference
READINGS = {
    "rmse_gap": "largest |test RMSE - the reference's| over the iterations "
                "the reference ran, in both calls",
    "rmse_gap_iter": "the iteration of rmse_gap (not compared)",
    "start_gap": "trajectory: largest of ||X - X_ref|| / ||X_ref|| "
                 "(Frobenius) over W and H after the set-up call's "
                 "iterations; step: the same per entity, the median entity",
    "w_gap": "trajectory: ||W - W_ref|| / ||W_ref|| after the window's call",
    "h_gap": "trajectory: ||H - H_ref|| / ||H_ref|| after the window's call",
    "pred_gap": "trajectory: RMS of (prediction - the reference's) over the "
                "held-out pairs after the window's call",
    "step_gap": "step: over W and H, the largest median over entities of "
                "||x - x_ref|| / ||x_ref|| after the step that follows the "
                "window, the reference stepping from the program's state",
    "step_res": "step: over W and H, the largest median over entities of "
                "the step's backward error ||G x - b|| / ||b||, G and b in "
                "float64 from the step's own inputs",
}


@dataclasses.dataclass
class MetricContext:
    """What a per-layer metric's reader reads (``metrics/__init__.py``)."""

    solver: str
    k: int
    rows: int
    cols: int
    nnz: int
    residual_dtype: str
    als_precision: str
    panels: Optional[list]
    plan_events: list
    trace: Optional[dict]


@dataclasses.dataclass
class Outcome:
    """A run's numbers and outputs: the window, the set-up, the set-up
    call's factors and RMSEs, the window call's RMSE by iteration and final
    factors, the program's state before the last step (``step`` check),
    and after the comparison the readings."""

    iters: int
    window_s: float
    setup_s: float
    peak_bytes: int
    warm_rmse: list
    rmse: dict
    warm: tuple
    W: np.ndarray
    H: np.ndarray
    state: Optional[tuple]
    context: Optional[MetricContext]
    readings: dict = dataclasses.field(default_factory=dict)
    checks: dict = dataclasses.field(default_factory=dict)

    @property
    def failed(self) -> int:
        """Window iterations whose test RMSE is not finite."""
        return sum(1 for it in range(2, self.iters + 2)
                   if not math.isfinite(self.rmse.get(it, float("nan"))))


def note(what: str) -> None:
    """A progress line on standard error, with the process's host clock."""
    print(f"[bench {time.perf_counter():10.3f}] {what}", file=sys.stderr,
          flush=True)


def _events_log():
    """A MetricsLog that keeps the solver's events in memory (``events``:
    (kind, fields) pairs) and prints nothing."""
    from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog

    class Events(MetricsLog):
        def __init__(self):
            super().__init__(None, echo=False)
            self.events = []

        def event(self, kind, **fields):
            self.events.append((kind, fields))

    return Events()


class _Window:
    """The window call's callback: the window's clock from iteration 1's
    callback to iteration ``last``'s, the test RMSE of every iteration
    and, in a traced run, the profiler over the window's last ``traced``
    iterations (its own host clock beside it)."""

    def __init__(self, last: int, traced: int):
        self.last, self.traced = last, traced
        self.rmse: dict = {}
        self.prof = None
        self.t0 = self.t1 = self.p0 = self.p1 = None

    def __call__(self, st) -> None:
        self.rmse[st.oiter] = st.rmse
        if st.oiter == self.last - self.traced and self.traced:
            self.prof = tracing.profiler()
            self.prof.__enter__()
            self.p0 = time.perf_counter()
        if st.oiter == 1:
            self.t0 = time.perf_counter()
        if st.oiter == self.last:
            self.t1 = time.perf_counter()
            if self.prof is not None:
                self.p1 = time.perf_counter()
                self.prof.__exit__(None, None, None)


def port_config(cell: spec.Cell, maxiter: int, control: bool = False):
    """The port's Config of the cell: the configuration's settings, the
    mix's plan settings for its solver, and with ``control`` the
    configuration's lower-precision program settings."""
    from cuda_recommender_tpu_torch.core.config import Config

    conf = cell.config
    settings = dict(conf["settings"])
    settings.update(cell.traffic.get("plan", {}).get(conf["solver"], {}))
    if control:
        settings.update(conf["control"]["program"])
    return Config(solver=conf["solver"], maxiter=maxiter, **settings)


def check_mode(cell: spec.Cell) -> str:
    return cell.config["check"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _als_state(payload: dict, R, cfg) -> tuple:
    """A slot-space ALS checkpoint payload in entity order, through the
    layout the entry builds from the same matrix and floor."""
    from cuda_recommender_tpu_torch.data.ell import build_ell_pair

    ell = build_ell_pair(R, min_width=cfg.als_min_width, num_shards=1)
    return (payload["W"][ell.rows_side.slot_of_entity],
            payload["H"][ell.cols_side.slot_of_entity])


def run_program(cell: spec.Cell, data: datagen.Ratings, seed: int,
                seconds: float, device, *, traced: bool = False,
                iters: Optional[int] = None, control: bool = False,
                fault: Optional[str] = None,
                t_start: Optional[float] = None) -> Outcome:
    """Set up, warm up and run the window of ``cell`` on ``data``.
    ``iters`` fixes N instead of timing it (the calibration's faults and
    controls); ``t_start`` is the host clock at the process's start
    (set-up runs from it to the window's start)."""
    from cuda_recommender_tpu_torch.core.init import init_factors_np
    from cuda_recommender_tpu_torch.core.trainer import check_supported, solve
    from cuda_recommender_tpu_torch.data.sparse import from_coo, make_test

    t_start = time.perf_counter() if t_start is None else t_start
    m, n = data.rows, data.cols
    R = from_coo(m, n, *data.train)
    T = make_test(m, n, *data.test)
    cfg = port_config(cell, WARM_ITERS, control)
    solver = cfg.solver.value
    backend = cfg.resolve_backend(m, n)
    check_supported(cfg, backend)
    W0, H0 = init_factors_np(cfg.k, m, n, seed=seed,
                             entity_major=solver == "als")
    log = _events_log()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    saved: dict = {}
    with faults.planted(fault, solver):
        run: dict = {}
        warm: list = []
        note("set-up: the entry's first call")
        Ww, Hw, _ = solve(cfg, backend, R, W0.copy(), H0.copy(), T,
                          device=device, callback=warm.append, log=log,
                          run=run)
        if iters is None:
            iters = max(1, math.ceil(seconds / warm[-1].rank_time))
        kw: dict = {}
        if "plan" in run:
            if run["transposed"]:
                raise ValueError("the benchmark passes the plan of users as "
                                 "rows; set hybrid_transpose false")
            kw["plan"] = run.pop("plan")
        if check_mode(cell) == "step":
            kw.update(ckpt_every=iters + 1,
                      ckpt_fn=lambda oiter, payload: saved.update(payload))
        note(f"set-up: the window's call, 1 + {iters} + 1 iterations")
        traced_iters = (min(iters, max(1, math.ceil(
            TRACE_SECONDS / warm[-1].rank_time))) if traced else 0)
        window = _Window(iters + 1, traced_iters)
        cfg = port_config(cell, iters + 2, control)
        W, H, _ = solve(cfg, backend, R, W0.copy(), H0.copy(), T,
                        device=device, callback=window, log=log, run={}, **kw)
    _sync(device)
    note("window's call returned")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    window_s = window.t1 - window.t0
    red = (tracing.reduce_profile(window.prof, window.p1 - window.p0,
                                  window.traced)
           if window.prof is not None else None)
    plans = [f for kind, f in log.events if kind in ("hybrid_plan",
                                                      "als_plan")]
    ctx = MetricContext(
        solver=solver, k=cfg.k, rows=m, cols=n, nnz=R.nnz,
        residual_dtype=cfg.residual_dtype, als_precision=cfg.als_precision,
        panels=next((f["panels"] for f in plans if "panels" in f), None),
        plan_events=plans, trace=red)
    state = _als_state(saved, R, cfg) if saved else None
    out = Outcome(iters=iters, window_s=window_s,
                  setup_s=window.t0 - t_start, peak_bytes=peak,
                  warm_rmse=[st.rmse for st in warm], rmse=window.rmse,
                  warm=(Ww, Hw), W=W, H=H, state=state, context=ctx)
    del R, T, run, kw, window, log, saved
    _free(device)
    return out


def reference_run(cell: spec.Cell, data: datagen.Ratings, seed: int,
                  out: Outcome, device, **options) -> dict:
    """The configuration's plain reference over what ``out`` ran, by the
    configuration's check: ``{"rmse": {window-call iteration: RMSE},
    "start": (W, H) after WARM_ITERS, "final": (W, H) after iteration
    N + 2}``. The initial factors are drawn as the program's are (the same
    seed through the same NumPy draws). ``options``: the reference's
    control settings (``tf32``)."""
    from cuda_recommender_tpu_torch.core.init import init_factors_np

    conf = cell.config
    s = conf["settings"]
    ref = spec.reference(conf)
    last = out.iters + 2
    lam = float(s["lambda_"])
    args = (data.rows, data.cols, data.train, data.test)
    if conf["solver"] == "ccd":
        W0, _ = init_factors_np(int(s["k"]), data.rows, data.cols, seed=seed)
        r = ref.ccd_train(*args, torch.as_tensor(W0), lam=lam,
                          inner=int(s.get("maxinneriter", 1)), iters=last,
                          device=device, keep=(WARM_ITERS,), **options)
        return {"rmse": dict(enumerate(r["rmse"], 1)),
                "start": r["kept"][WARM_ITERS], "final": (r["W"], r["H"])}
    W0, H0 = init_factors_np(int(s["k"]), data.rows, data.cols, seed=seed,
                             entity_major=True)
    r = ref.als_train(*args, torch.as_tensor(W0), torch.as_tensor(H0),
                      lam=lam, iters=WARM_ITERS, device=device, **options)
    rmse = dict(enumerate(r["rmse"], 1))
    step = ref.als_train(*args, torch.as_tensor(out.state[0]),
                         torch.as_tensor(out.state[1]), lam=lam, iters=1,
                         device=device, **options)
    rmse[last] = step["rmse"][0]
    return {"rmse": rmse, "start": (r["W"], r["H"]),
            "final": (step["W"], step["H"])}


def _rel(A: np.ndarray, B: np.ndarray) -> float:
    ref = float(np.linalg.norm(B.astype(np.float64)))
    gap = float(np.linalg.norm(A.astype(np.float64) - B))
    return gap / ref if ref > 0 else gap


def _rows_rel(A: np.ndarray, B: np.ndarray) -> float:
    """The median over entities (rows of entity-major factors) of
    ||a - b|| / ||b||, over the rows where b is not zero."""
    A, B = A.astype(np.float64), B.astype(np.float64)
    ref = np.linalg.norm(B, axis=1)
    keep = ref > 0
    if not keep.any():
        return float(np.linalg.norm(A))
    gaps = np.linalg.norm(A - B, axis=1)[keep] / ref[keep]
    return float(np.median(gaps))


def _pred_gap(W, H, Wr, Hr, test: tuple, rank_major: bool, device) -> float:
    ti = torch.as_tensor(test[0], device=device).to(torch.int64)
    tj = torch.as_tensor(test[1], device=device).to(torch.int64)

    def preds(W, H):
        W = torch.as_tensor(W, device=device, dtype=torch.float64)
        H = torch.as_tensor(H, device=device, dtype=torch.float64)
        if rank_major:
            W, H = W.t(), H.t()
        return (W[ti] * H[tj]).sum(dim=1)

    d = preds(W, H) - preds(Wr, Hr)
    return float(torch.sqrt((d * d).mean())) if d.numel() else 0.0


def compare(out: Outcome, ref: dict, data: datagen.Ratings, mode: str,
            rank_major: bool, device) -> dict:
    """The readings of ``out`` against the reference run ``ref``."""
    gaps = [(abs(r - ref["rmse"][it]), it)
            for it, r in enumerate(out.warm_rmse, 1)]
    gaps += [(abs(out.rmse.get(it, float("nan")) - r), it)
             for it, r in ref["rmse"].items()]
    worst = max(gaps, key=lambda g: (not math.isfinite(g[0]), g[0]))
    (Ws, Hs), (Wf, Hf) = ref["start"], ref["final"]
    readings = {"rmse_gap": worst[0], "rmse_gap_iter": worst[1]}
    if mode == "step":
        readings.update(
            start_gap=max(_rows_rel(out.warm[0], Ws),
                          _rows_rel(out.warm[1], Hs)),
            step_gap=max(_rows_rel(out.W, Wf), _rows_rel(out.H, Hf)))
    else:
        readings.update(start_gap=max(_rel(out.warm[0], Ws),
                                      _rel(out.warm[1], Hs)),
                        w_gap=_rel(out.W, Wf), h_gap=_rel(out.H, Hf),
                        pred_gap=_pred_gap(out.W, out.H, Wf, Hf, data.test,
                                           rank_major, device))
    return readings


def readings_of(cell: spec.Cell, out: Outcome, ref: dict,
                data: datagen.Ratings, device) -> dict:
    """``compare``'s readings, and for the ``step`` check the backward
    error of the program's step (``step_res``), judged by the reference's
    float64 normal equations over the step's own inputs."""
    readings = compare(out, ref, data, check_mode(cell),
                       cell.config["solver"] == "ccd", device)
    if check_mode(cell) == "step":
        readings["step_res"] = spec.reference(cell.config).step_residual(
            data.rows, data.cols, data.train, out.state, (out.W, out.H),
            lam=float(cell.config["settings"]["lambda_"]), device=device)
    return readings


def judge(readings: dict, limits: Optional[dict]) -> tuple[bool, dict]:
    """(correct, checks): each number the cell's limits name beside its
    limit; correct where every one is finite and within it. Without
    limits nothing can be judged: not correct."""
    if not limits:
        return False, {}
    checks = {}
    for name, lim in limits["limits"].items():
        value = readings.get(name, float("nan"))
        checks[name] = {"value": value, "limit": lim["limit"]}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def control_readings(cell: spec.Cell, data: datagen.Ratings, seed: int,
                     out: Outcome, ref: dict, device) -> dict:
    """The readings of the cell's control at the sound run ``out``'s
    iteration count: the program on its own lower-precision path
    (``control.program``), or the reference computed in the lower
    precision in the program's place (``control.reference``; its step
    from the program's state), against the reference ``ref``."""
    ctrl = cell.config["control"]
    if "program" in ctrl:
        low = run_program(cell, data, seed, 0.0, device, iters=out.iters,
                          control=True)
    else:
        r = reference_run(cell, data, seed, out, device, **ctrl["reference"])
        low = dataclasses.replace(
            out, warm_rmse=[r["rmse"][it] for it in range(1, WARM_ITERS + 1)],
            rmse=r["rmse"], warm=r["start"], W=r["final"][0],
            H=r["final"][1], context=None)
    return readings_of(cell, low, ref, data, device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, device, *,
             traced: bool = False, t_start: Optional[float] = None,
             data: Optional[datagen.Ratings] = None) -> Outcome:
    """One run: data, program, reference, comparison. ``data``: the
    ratings of this seed, where the caller made them already."""
    if data is None:
        note("data")
        data = datagen.generate(cell.traffic, seed, device)
        _free(device)
    out = run_program(cell, data, seed, seconds, device, traced=traced,
                      t_start=t_start)
    note("reference")
    ref = reference_run(cell, data, seed, out, device)
    out.readings = readings_of(cell, out, ref, data, device)
    note("compared")
    del ref
    _free(device)
    return out
