"""The flagship sweep (the port of ``scripts/sweep_netflix_hybrid.py``):
the hybrid backend at Netflix-100M dims over k x panel budget x stair
(the hand stair (4096, 2048) against the auto stair), with group-difference
timing, one JSONL line per (row, repeat).

    python -m cuda_recommender_tpu_torch.scripts.sweep_netflix_hybrid \\
        [quick|rows=I,J,...] [--out FILE] [--device cuda]

The grid is the JAX script's (``:52-75``): ``synthetic_cached(480189,
17770, 100_000_000, seed=1, test_fraction=0.02)``, λ = 0.05, a bf16
residual with NaN sentinels and the panel kernels (K1, K2), budgets 2.0e9,
4.2e9 and 6.5e9 cells x the hand or auto stair x k in {10, 40, 100}, and
the k in {5, 20, 50} and T = 7 rows at 6.5e9 under the hand stair: 15 rows,
``REPEATS`` = 2 each. ``quick`` runs the first two rows, ``rows=`` the
listed ones (indices into ``GRID``).

Each plan is made once (with k = 40, as the JAX script plans) and kept
for every row that uses it. A repeat densifies fresh panels from the
seed-0 init after the previous repeat's state is freed. The repeats run
in turns: where the hand and the auto stair share (k, budget, T), hand
repeat 0, auto repeat 0, hand repeat 1, auto repeat 1, so that the two
stairs' times are taken side by side.

Timing (the JAX script's ``:142-158``): one first iteration (``compile_s``:
no compile here, the first launches), then ``PAIRS`` pairs of a group of 1
and a group of ``GROUP`` back-to-back outer iterations, each group ended by
``torch.cuda.synchronize()`` on the host clock; ``iter_s`` = (median of the
GROUP-groups - median of the 1-groups) / (GROUP - 1), so the fence's cost
cancels; ``iter_s_pair_samples`` the same a pair. ``rmse_after_iters`` is
the test RMSE (f64 on the host) after the 1 + PAIRS x (1 + GROUP)
iterations, held against the JAX records' row of the same (k, budget,
widths, T) (``sweep_netflix_hybrid_r5.jsonl`` where it has the row, else
``_r4``) within ``RMSE_TOL``, the bf16 trajectory bar; a miss exits 1.

Each line has the JAX script's keys (``device`` is the card's name and
power limit, ``scripts/common.py::card``) and the
port's: ``row``, ``launches`` (K1 and K2 must launch on the card),
``iter_s_group_samples`` and the JAX row's RMSE and file. Lines are
printed and appended to ``--out`` (default ``cuda_recommender_tpu_torch/
results/sweep_netflix_hybrid.jsonl``; none with ``--out ''``).

``CRTPU_DEFER_GROUP`` (default 0), as in the JAX script, sets every row's
``hybrid_defer_group``: the rank-deferred ELL tail, the line's
``defer_group`` (the JAX r4 grid ran G = 8). ``CRTPU_BENCH_CPU=1`` with
``--device cpu`` runs the JAX script's CPU grid (6,040 x 3,706, 900,000
ratings, k = 8, a 2,000-row budget, the (256,) and auto stairs, groups of
2); times are then null.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..core.init import init_factors_np
from ..data.datasets import synthetic_cached
from ..eval.metrics import calrmse_np
from ..ops import launches
from ..solvers import ccd_hybrid as ch
from .common import card
from .run_trajectories import JAX_RECORDS, OUT_DIR

DIMS = (480_189, 17_770, 100_000_000)
BUDGETS = {"2.0e9": 2_000_000_000, "4.2e9": 4_200_000_000,
           "6.5e9": 6_500_000_000}
HAND = (4096, 2048)
#: (k, budget tag, widths, inner iterations): the JAX script's rows 0-14
GRID = [
    (10, "2.0e9", HAND, 1), (10, "4.2e9", HAND, 1), (10, "6.5e9", HAND, 1),
    (40, "2.0e9", HAND, 1), (40, "4.2e9", HAND, 1), (40, "6.5e9", HAND, 1),
    (40, "2.0e9", "auto", 1), (40, "4.2e9", "auto", 1),
    (40, "6.5e9", "auto", 1),
    (100, "6.5e9", HAND, 1), (100, "6.5e9", "auto", 1),
    (5, "6.5e9", HAND, 1), (20, "6.5e9", HAND, 1), (50, "6.5e9", HAND, 1),
    (40, "6.5e9", HAND, 7),
]
#: the headline's row: k = 40, 6.5e9 cells, the hand stair, T = 1
HEADLINE_ROW = 5
#: CRTPU_BENCH_CPU=1: the JAX script's CPU grid
CPU_DIMS = (6_040, 3_706, 900_000)
CPU_BUDGETS = {"small": 2_000 * 3_706}
CPU_GRID = [(8, "small", (256,), 1), (8, "small", "auto", 1)]
LAM = 0.05
REPEATS = 2
PAIRS = 3
GROUP, CPU_GROUP = 4, 2
#: |rmse_after_iters - the JAX row's| allowed: the bf16 trajectory bar
RMSE_TOL = 0.02
#: the JAX records, newest first: a row is read from the first that has it
JAX_FILES = ("sweep_netflix_hybrid_r5.jsonl", "sweep_netflix_hybrid_r4.jsonl")
OUT = os.path.join(OUT_DIR, "sweep_netflix_hybrid.jsonl")


def defer_group() -> int:
    """``CRTPU_DEFER_GROUP``: the rows' rank-deferral group (0: none)."""
    return int(os.environ.get("CRTPU_DEFER_GROUP", "0"))


def shape(cpu: bool) -> dict:
    """The dims, budgets, grid and group size: the JAX script's, full or
    (``cpu``) its CPU grid."""
    if cpu:
        return {"dims": CPU_DIMS, "budgets": CPU_BUDGETS, "grid": CPU_GRID,
                "group": CPU_GROUP}
    return {"dims": DIMS, "budgets": BUDGETS, "grid": GRID, "group": GROUP}


def make_plan(R, budget: int, widths) -> tuple:
    """(plan, host seconds) of the NaN-panel hybrid under ``budget`` cells
    with ``widths`` (a tuple, or "auto"), planned at k = 40 as the JAX
    script plans every row."""
    cfg = Config(k=40, lambda_=LAM, backend="hybrid",
                 residual_dtype="bfloat16", mask_dtype="nan",
                 hybrid_dense_cells=budget, hybrid_panel_widths=widths,
                 hybrid_panel_kernel=True)
    t0 = time.perf_counter()
    plan = ch.plan_hybrid(R, cfg, materialize_dense=False)
    return plan, time.perf_counter() - t0


def fresh_state(plan, k: int, dev):
    """The training state at outer iteration 1 from the seed-0 init: bf16
    NaN panels densified on ``dev``."""
    W0, _ = init_factors_np(k, plan.row_nnz.shape[0], plan.col_nnz.shape[0],
                            seed=0)
    return ch.initial_state(plan, W0, torch.bfloat16, dev, "nan")


def fence(dev):
    """A call that waits for ``dev``'s queued work."""
    return ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))


def group_timing(run, sync, pairs: int, group: int) -> dict:
    """``pairs`` pairs of a group of 1 and a group of ``group`` calls of
    ``run``, each group fenced by ``sync``: the group-difference s/iter, a
    sample a pair, their spread in % of it, and the groups' seconds."""
    def grp(g):
        t0 = time.perf_counter()
        for _ in range(g):
            run()
        sync()
        return time.perf_counter() - t0

    t1s, tgs = [], []
    for _ in range(pairs):
        t1s.append(grp(1))
        tgs.append(grp(group))
    dt = (statistics.median(tgs) - statistics.median(t1s)) / (group - 1)
    pair = [(g - o) / (group - 1) for g, o in zip(tgs, t1s)]
    return {"iter_s": dt, "iter_s_pair_samples": pair,
            "iter_s_spread_pct": (100.0 * (max(pair) - min(pair)) / dt
                                  if dt else 0.0),
            "iter_s_group_samples": {"1": t1s, str(group): tgs}}


def jax_rows(path: str = JAX_RECORDS) -> dict:
    """{(k, budget_cells, widths, inner): (rmse_after_iters, file)} of the
    JAX records, each row from the newest file that has it."""
    rows = {}
    for name in JAX_FILES:
        with open(os.path.join(path, name)) as f:
            for rec in map(json.loads, f):
                rows.setdefault(row_key(rec), (rec["rmse_after_iters"], name))
    return rows


def row_key(rec: dict) -> tuple:
    w = rec["widths"]
    return (rec["k"], rec["budget_cells"], "auto" if w == "auto"
            else tuple(w), rec["inner"])


def turns(grid: list, indices: list, repeats: int) -> list:
    """(row index, repeat) in run order: rows that differ only in their
    stair take their repeats in turns, the others one after another, in
    the order of their first row."""
    groups: dict = {}
    for i in indices:
        k, btag, _, inner = grid[i]
        groups.setdefault((k, btag, inner), []).append(i)
    return [(i, rep) for rows in groups.values() for rep in range(repeats)
            for i in rows]


def run_repeat(R, T, plan, plan_s: float, row: tuple, dev, *, rep: int = 0,
               budgets: dict = BUDGETS, group: int = GROUP,
               jax: dict | None = None) -> tuple:
    """One (row, repeat): a fresh state, the timing, the RMSE. Returns
    (record, state, step); the caller frees the state."""
    k, btag, widths, inner = row
    on_card = dev.type == "cuda"
    st = fresh_state(plan, k, dev)
    defer = defer_group()
    step = ch.make_hybrid_outer_step(plan, ch.device_plan(plan, dev), LAM,
                                     inner, order="once",   # bf16: once
                                     defer_group=defer)
    sync = fence(dev)
    sync()
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    step(st)
    sync()
    first_s = time.perf_counter() - t0
    tm = group_timing(lambda: step(st), sync, PAIRS, group)
    counts = {name: n for name, n in launches.launch_counts().items() if n}
    if on_card and not (counts.get("panel_update_vsweep")
                        and counts.get("panel_usweep")):
        raise AssertionError(f"row {row}: K1 and K2 did not both launch: "
                             f"{counts}")
    W = st.W.cpu().numpy()[:, plan.user_pos]
    H = st.H.cpu().numpy()[:, plan.item_pos]
    rmse = calrmse_np(T, W, H, entity_major=False)
    if not on_card:
        tm = {key: None for key in tm}
    dt = tm["iter_s"]
    key = (k, budgets[btag], widths, inner)
    want = (jax or {}).get(key, (None, None))
    rec = {
        "dataset": f"netflix-dims synthetic zipf ({R.rows}x{R.cols}, "
                   f"nnz={R.nnz})",
        "solver": "ccd", "backend": "hybrid", "k": k, "inner": inner,
        "lambda": LAM, "budget_cells": budgets[btag],
        "widths": "auto" if widths == "auto" else list(widths),
        "panels": [list(p) for p in plan.panels],
        "nnz_light_frac": round(plan.nnz_light / R.nnz, 4),
        "defer_group": defer, "repeat": rep, "plan_s": plan_s,
        "compile_s": first_s if on_card else None,
        "iter_s": dt, "iter_s_pair_samples": tm["iter_s_pair_samples"],
        "iter_s_spread_pct": tm["iter_s_spread_pct"],
        "rating_updates_per_s_M": R.nnz * k / dt / 1e6 if dt else None,
        "rmse_after_iters": rmse, "panel_kernel": on_card,
        "residual_dtype": "bfloat16", "mask_dtype": "nan",
        "device": card(dev), "date": time.strftime("%Y-%m-%d"),
        "iter_s_group_samples": tm["iter_s_group_samples"],
        "iterations": 1 + PAIRS * (1 + group), "launches": counts,
        "rmse_after_iters_jax": want[0], "rmse_jax_record": want[1]}
    return rec, st, step


def run(indices: list, dev, cpu: bool, *, out: str | None = None) -> list:
    """The rows ``indices`` of the grid, REPEATS each, in turns; each line
    printed and appended to ``out``."""
    sh = shape(cpu)
    grid = sh["grid"]
    t0 = time.perf_counter()
    R, T = synthetic_cached(*sh["dims"], seed=1, test_fraction=0.02)
    print(f"[flagship] data {time.perf_counter() - t0:.1f} s (host)",
          flush=True)
    jax = None if cpu else jax_rows()
    plans: dict = {}
    recs = []
    for i, rep in turns(grid, indices, REPEATS):
        k, btag, widths, inner = grid[i]
        if (btag, widths) not in plans:
            plans[btag, widths] = make_plan(R, sh["budgets"][btag], widths)
        plan, plan_s = plans[btag, widths]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec, st, step = run_repeat(R, T, plan, plan_s, grid[i], dev, rep=rep,
                                   budgets=sh["budgets"], group=sh["group"],
                                   jax=jax)
        del st, step
        rec["row"] = i
        recs.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            os.makedirs(os.path.dirname(os.path.abspath(out)),
                        exist_ok=True)
            with open(out, "a") as f:
                f.write(line + "\n")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return recs


def rmse_misses(recs: list) -> list:
    """Lines whose ``rmse_after_iters`` lies more than RMSE_TOL from the
    JAX row's (read to the ninth decimal), or that have no JAX row."""
    misses = []
    for rec in recs:
        want = rec["rmse_after_iters_jax"]
        what = (f"row {rec['row']} (k={rec['k']}, {rec['budget_cells']}, "
                f"{rec['widths']}, T={rec['inner']}) repeat {rec['repeat']}")
        if want is None:
            misses.append(f"{what}: no JAX row")
            continue
        diff = round(abs(rec["rmse_after_iters"] - want), 9)
        if diff > RMSE_TOL:
            misses.append(f"{what}: rmse {rec['rmse_after_iters']:.6f}, "
                          f"{diff} off the JAX row's {want} (bar "
                          f"{RMSE_TOL})")
    return misses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.sweep_netflix_hybrid",
        description="the flagship hybrid sweep: k x budget x stair")
    p.add_argument("select", nargs="?", default="",
                   help="'quick' (rows 0-1) or 'rows=I,J,...'")
    p.add_argument("--out", default=OUT,
                   help="JSONL file the lines are appended to ('' for none)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cpu = bool(os.environ.get("CRTPU_BENCH_CPU"))
    if cpu != (args.device == "cpu"):
        print("sweep_netflix_hybrid: CRTPU_BENCH_CPU=1 (the CPU grid) and "
              "--device cpu go together; the full grid runs on the card",
              file=sys.stderr)
        return 2
    grid = shape(cpu)["grid"]
    if args.select == "quick":
        indices = [0, 1]
    elif args.select.startswith("rows="):
        indices = sorted({int(x) for x in args.select[5:].split(",")})
        if not set(indices) <= set(range(len(grid))):
            p.error(f"rows lie in 0-{len(grid) - 1}")
    elif args.select:
        p.error(f"unknown selection {args.select!r}")
    else:
        indices = list(range(len(grid)))
    dev = resolve_device(args.device)
    recs = run(indices, dev, cpu, out=args.out)
    misses = [] if cpu else rmse_misses(recs)
    for miss in misses:
        print(f"MISS {miss}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
