"""Training at the reference sweep's two Yahoo geometries (the port of
``scripts/yahoo_robustness.py``; the reference's grid,
``scripts/times.sh:29-66``, sweeps yahoor1, about 1.9M x 98k, and yahooc15,
about 1M x 625k, with CCD++ and ALS).

    python -m cuda_recommender_tpu_torch.scripts.yahoo_robustness \\
        [all|r1,c15,r1_t,c15_t,als_r1,als_c15] [--out FILE] [--device cuda]

Jobs, on Zipf synthetic data at the JAX script's ``SPECS`` (seed 11, 2%
held out), k = 40, λ = 0.05:

* ``r1``, ``c15``: the hybrid at a bf16 residual with NaN sentinels and the
  panel kernels (K1, K2), the auto stair under 6e9 cells; ``r1_t``,
  ``c15_t`` the same on the transposed problem (``R.transpose()`` and the
  test set's axes swapped, as the JAX script does: the stair then covers
  top items x user prefixes);
* ``als_r1``, ``als_c15``: ALS on the ELL backend, solver gj (K5),
  precision "highest", ``als_min_width`` "auto", 2048 MB row groups. The
  port runs the gathers untiled (ROADMAP.md "Not ported: ALS gather-cliff
  tiling"; ``gather_tiling`` is null).

Each job trains 1 + 3 x (1 + 6) = 22 outer iterations through the trainer,
the JAX script's count, so ``rmse_after_iters`` (test RMSE of the final
factors, float64 on the host) compares with its records. Timing is the
port's: the trainer's host clock around each outer iteration and its RMSE,
ending in ``torch.cuda.synchronize()``; a line per iteration; ``iter_s``
is the median of iterations 2-21. Iteration 22 runs under torch.profiler:
its device busy time split into K1, K2 and the rest (the ELL tail's
gathers and scatters, the remaps, the half-sweep divisions) for the
hybrid, into the gram products, gathers, K5 and the rest for ALS.

``bound_iter_s`` is the least time an iteration could take on the card:
for the hybrid, k x (panel cells x 6 B over 3.35 TB/s + each tail side's
padded lanes at P3 form B's time per element, measured here at that side's
shape, as the bench's ``vs_baseline_achievable`` counts the tail); for
ALS, the gram and rhs assembly's bytes or f32 operations, whichever is
larger (each rating's index and value read once a side, each slot's
(k+1)² gram written once, 2·(k+1)² operations a rating and side over
67 TFLOP/s), the K5 solves not counted. ``frac_of_bound`` is it over
``iter_s``. The launch counts of K1/K2 or K5 come from ``ops/launches.py``.

``CRTPU_BENCH_CPU=1`` with ``--device cpu`` shrinks the dims as the JAX
script's does (k = 8, 1 + 2 x (1 + 2) = 7 iterations) for a CPU flow check;
times and bounds are then null. One JSON line per job, also written to
``--out`` (default ``cuda_recommender_tpu_torch/results/
yahoo_robustness.jsonl``; none with ``--out ''``), where it takes the
place of an earlier line of the same job: the file keeps one line a job,
so the jobs can run one process each.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
import time

import torch

from ..bench import PANEL_BYTES_PER_CELL, tail_sides
from ..core.config import Config
from ..core.device import resolve_device
from ..core.init import init_factors_np
from ..core.metrics_log import MetricsLog
from ..data.datasets import synthetic_cached
from ..eval.metrics import calrmse_np
from ..ops import launches
from ..solvers.als_ell import als_ell_train
from ..solvers.ccd_hybrid import ccd_hybrid_train, transpose_test
from .common import PEAK_BYTES_S, PEAK_F32_FLOP_S, assembly_bound, card
from .probe_gather import gather_probe, tail_shape
from .profile_iteration import kernel_split, profiler, trace_split
from .run_trajectories import OUT_DIR

#                 m        n       nnz    budget_cells
SPECS = {
    "r1": (1_948_883, 98_211, 115_000_000, 6_000_000_000),
    "c15": (1_000_990, 624_961, 100_000_000, 6_000_000_000),
}
#: CRTPU_BENCH_CPU=1: the JAX script's shrunk dims
CPU_SPECS = {"r1": (1_900, 98, 115_000, 60_000),
             "c15": (1_000, 625, 100_000, 60_000)}
#: job -> (geometry, solver, transposed)
JOBS = {"r1": ("r1", "ccd", False), "c15": ("c15", "ccd", False),
        "c15_t": ("c15", "ccd", True), "r1_t": ("r1", "ccd", True),
        "als_r1": ("r1", "als", False), "als_c15": ("c15", "als", False)}
#: the JAX records' rmse_after_iters (results/yahoo_robustness_r4.jsonl,
#: r5.jsonl; TPU v5e, 22 iterations)
RMSE_JAX = {"r1": 0.1948, "c15": 0.193, "r1_t": 0.1965, "c15_t": 0.1941,
            "als_r1": 0.4246, "als_c15": 0.2214}
LAM = 0.05
#: the hybrid's busy time by part (kernel name patterns); the rest is the
#: ELL tail, the remaps and the half-sweep divisions
HYBRID_PARTS = (("K1", re.compile(r"col_sweep|col_reduce")),
                ("K2", re.compile(r"row_sweep")))
OUT = os.path.join(OUT_DIR, "yahoo_robustness.jsonl")


def shape(cpu: bool) -> dict:
    """k, the timing rounds and group size, and the specs: the JAX
    script's on the card (k = 40, 3 x (1 + 6)) or shrunk (k = 8,
    2 x (1 + 2))."""
    k, rounds, group = (8, 2, 2) if cpu else (40, 3, 6)
    return {"k": k, "iters": 1 + rounds * (1 + group),
            "specs": CPU_SPECS if cpu else SPECS}


class Timer:
    """The trainer's callback: a line per iteration, and the last iteration
    under torch.profiler (started when the one before it is reported)."""

    def __init__(self, name: str, iters: int, device):
        self.name, self.iters, self.device = name, iters, device
        self.samples: list = []
        self.prof = None
        self.trace: dict = {}

    def __call__(self, st) -> None:
        print(f"[{self.name}] iteration {st.oiter}: {st.rank_time:.4f} s, "
              f"rmse {st.rmse:.6f}", flush=True)
        self.samples.append(st.rank_time)
        if st.oiter == self.iters - 1:
            self.prof = profiler(self.device)
            self.prof.__enter__()
        elif st.oiter == self.iters and self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.trace = trace_split(self.prof, st.rank_time)
            self.prof = None

    def timing(self, on_card: bool) -> dict:
        """The iteration times (the card's only; None on the CPU): the
        first, the median of the steady ones (all but the first and the
        profiled last), every sample, and the trace's summary."""
        steady = self.samples[1:-1]
        trace = self.trace
        if not (on_card and steady):
            return {"first_iter_s": None, "iter_s": None,
                    "iter_s_samples": None, "iter_s_min_max": None,
                    "profiled": None, "top_kernels": None}
        return {"first_iter_s": self.samples[0],
                "iter_s": statistics.median(steady),
                "iter_s_samples": self.samples,
                "iter_s_min_max": [min(steady), max(steady)],
                "profiled": {key: trace.get(key) for key in (
                    "wall_ms", "span_ms", "busy_ms", "idle_pct")},
                "top_kernels": trace.get("kernels", [])[:12]}


def run_hybrid(name: str, dev, cpu: bool) -> dict:
    geo, _, transpose = JOBS[name]
    sh = shape(cpu)
    m, n, nnz, budget = sh["specs"][geo]
    k, iters = sh["k"], sh["iters"]
    t0 = time.perf_counter()
    R, T = synthetic_cached(m, n, nnz, seed=11, test_fraction=0.02)
    data_s = time.perf_counter() - t0
    if transpose:
        R, T = R.transpose(), transpose_test(T)
        m, n = n, m
    cfg = Config(k=k, lambda_=LAM, maxiter=iters, backend="hybrid",
                 residual_dtype="bfloat16", mask_dtype="nan",
                 hybrid_dense_cells=budget, hybrid_panel_widths="auto",
                 hybrid_panel_kernel=True)
    W0, H0 = init_factors_np(k, m, n, seed=0)
    timer = Timer(name, iters, dev)
    run: dict = {}
    launches.reset_launch_counts()
    W, H, _ = ccd_hybrid_train(R, W0, H0, T, cfg, device=dev, run=run,
                               callback=timer)
    counts = {key: c for key, c in launches.launch_counts().items() if c}
    on_card = dev.type == "cuda"
    if on_card and not (counts.get("panel_update_vsweep")
                        and counts.get("panel_usweep")):
        raise AssertionError(f"{name}: K1 and K2 did not both launch: "
                             f"{counts}")
    rmse = calrmse_np(T, W, H, entity_major=False)
    plan = run["plan"]
    tm = timer.timing(on_card)
    panel_cells = sum((r1 - r0) * w for r0, r1, w in plan.panels)
    sides = tail_sides(plan)
    lanes = sum(s["lanes"] for s in sides.values())
    tail_s = 0.0 if on_card else None
    if on_card:
        torch.cuda.empty_cache()
        for side in sides.values():
            if side["lanes"]:
                g = gather_probe(*tail_shape(side["lanes"],
                                             side["table_rows"],
                                             side["width"]), dev,
                                 library=False)
                side["gather_B_ns_per_element"] = g["B"]["ns_per_element"]
                tail_s += side["lanes"] * g["B"]["ns_per_element"] * 1e-9
    bound = (k * (panel_cells * PANEL_BYTES_PER_CELL / PEAK_BYTES_S
                  + tail_s) if on_card else None)
    split = (kernel_split(timer.trace, HYBRID_PARTS, "tail_and_rest")
             if on_card else None)
    busy = timer.trace.get("busy_ms")
    dt = tm["iter_s"]
    return {
        "workload": f"hybrid CCD++ yahoo{geo}-dims synthetic zipf ({m}x{n}, "
                    f"nnz={R.nnz}), k={k}, bf16+nan, panel kernels"
                    + (", TRANSPOSED stair (top-items x user prefixes)"
                       if transpose else ""),
        "transposed_stair": transpose,
        "panels": [list(p) for p in plan.panels],
        "n_panels": len(plan.panels),
        "panel_cells": int(panel_cells),
        "nnz_light_frac": plan.nnz_light / R.nnz,
        "tail": sides,
        "lanes_padded": int(lanes),
        "data_s": data_s, "plan_s": run["plan_s"], "setup_s": run["setup_s"],
        "iterations": iters, **tm,
        "updates_per_s_M": R.nnz * k / dt / 1e6 if dt else None,
        "bound_iter_s": bound,
        "frac_of_bound": bound / dt if bound and dt else None,
        "bound_def": f"k x (panel cells x {PANEL_BYTES_PER_CELL} B / "
                     f"{PEAK_BYTES_S / 1e12} TB/s + per tail side padded "
                     "lanes x gather form B's measured time per element "
                     "at that side's shape)",
        "busy_ms_by_part": split,
        "tail_share_of_busy": (split["tail_and_rest"] / busy
                               if split and busy else None),
        "launches": counts,
        "rmse_after_iters": rmse,
        "rmse_after_iters_jax": None if cpu else RMSE_JAX[name],
        "device": card(dev),
    }


def run_als(name: str, dev, cpu: bool) -> dict:
    geo = JOBS[name][0]
    sh = shape(cpu)
    m, n, nnz, _ = sh["specs"][geo]
    k, iters = sh["k"], sh["iters"]
    t0 = time.perf_counter()
    R, T = synthetic_cached(m, n, nnz, seed=11, test_fraction=0.02)
    data_s = time.perf_counter() - t0
    cfg = Config(solver="als", k=k, lambda_=LAM, maxiter=iters,
                 als_solver="gj", als_precision="highest", als_group_mb=2048)
    W0, H0 = init_factors_np(k, m, n, seed=0, entity_major=True)
    timer = Timer(name, iters, dev)
    launches.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        events = os.path.join(tmp, "events.jsonl")
        log = MetricsLog(events)
        try:
            W, H, _ = als_ell_train(R, W0, H0, T, cfg, device=dev, log=log,
                                    callback=timer)
        finally:
            log.close()
        with open(events) as f:
            plan = next(e for e in map(json.loads, f)
                        if e["kind"] == "als_plan")
    counts = {key: c for key, c in launches.launch_counts().items() if c}
    on_card = dev.type == "cuda"
    if on_card and not counts.get("gj_solve"):
        raise AssertionError(f"{name}: K5 did not launch: {counts}")
    rmse = calrmse_np(T, W, H, entity_major=True)
    tm = timer.timing(on_card)
    sides = plan["sides"]
    lanes = sum(s["padded_lanes"] for s in sides.values())
    bound_ms, bound_by = assembly_bound(R.nnz, m + n, k, "highest")
    bound = bound_ms / 1e3
    split = kernel_split(timer.trace) if on_card else None
    dt = tm["iter_s"]
    return {
        "workload": f"ALS yahoo{geo}-dims synthetic zipf ({m}x{n}, "
                    f"nnz={R.nnz}), k={k}, GJ solve, precision HIGHEST",
        "min_width": cfg.als_min_width,
        "resolved_floors": {side: min(s["widths"])
                            for side, s in sides.items()},
        "als_group_mb": cfg.als_group_mb,
        "gather_tiling": None,
        "gather_tiling_note": "not in the port (ROADMAP.md 'Not ported: "
                              "ALS gather-cliff tiling'): every side "
                              "gathers untiled",
        "pad_factor_vs_nnz": lanes / (2 * R.nnz),
        "lanes_padded": int(lanes),
        "data_s": data_s, "plan_s": plan["plan_s"],
        "setup_s": plan["setup_s"],
        "iterations": iters, **tm,
        "ratings_per_s_M": R.nnz / dt / 1e6 if dt else None,
        "bound_iter_s": bound if on_card else None,
        "bound_by": bound_by,
        "frac_of_bound": bound / dt if on_card and dt else None,
        "bound_def": "gram and rhs assembly at f32: max(bytes (2 sides x "
                     "nnz x 12 B + slots x (k+1)^2 x 4 B) / "
                     f"{PEAK_BYTES_S / 1e12} TB/s, 2 sides x nnz x 2(k+1)^2 "
                     f"operations / {PEAK_F32_FLOP_S / 1e12:g} TFLOP/s); "
                     "K5's solves not counted",
        "busy_ms_by_part": split,
        "k5_launches_per_iter": plan["k5_launches_per_iter"],
        "launches": counts,
        "rmse_after_iters": rmse,
        "rmse_after_iters_jax": None if cpu else RMSE_JAX[name],
        "device": card(dev),
    }


def write_record(path: str, rec: dict) -> None:
    """Put ``rec`` into the JSON-lines file ``path`` in place of the
    line of the same job, or after the last line if it has none."""
    recs = {}
    if os.path.exists(path):
        with open(path) as f:
            recs = {r["name"]: r for r in map(json.loads, f)}
    recs[rec["name"]] = rec
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".tmp", "w") as f:
        for r in recs.values():
            f.write(json.dumps(r) + "\n")
    os.replace(path + ".tmp", path)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.yahoo_robustness",
        description="hybrid and ALS training at the Yahoo geometries")
    p.add_argument("jobs", nargs="?", default="all",
                   help="'all' or comma-separated: " + ", ".join(JOBS))
    p.add_argument("--out", default=OUT,
                   help="JSON-lines file of one record a job; a job's new "
                        "record replaces its old one ('' for none)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cpu = bool(os.environ.get("CRTPU_BENCH_CPU"))
    if cpu != (args.device == "cpu"):
        print("yahoo_robustness: CRTPU_BENCH_CPU=1 (the shrunk dims) and "
              "--device cpu go together; the full dims run on the card",
              file=sys.stderr)
        return 2
    names = list(JOBS) if args.jobs == "all" else args.jobs.split(",")
    unknown = set(names) - set(JOBS)
    if unknown:
        p.error(f"unknown jobs {sorted(unknown)}")
    dev = resolve_device(args.device)
    for name in names:
        rec = (run_als if JOBS[name][1] == "als" else run_hybrid)(
            name, dev, cpu)
        rec["name"] = name
        print(json.dumps(rec), flush=True)
        if args.out:
            write_record(args.out, rec)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
