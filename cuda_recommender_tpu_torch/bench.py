"""The port's benchmark: prints ONE JSON line
``{"metric", "value", "unit", "vs_baseline", "detail"}``.

    python -m cuda_recommender_tpu_torch.bench [--panel-widths auto|W1,W2]
        [--transpose 0|1|auto] [--iters 5] [--warmup 2] [--device cuda]

The workload is the JAX package's headline (``bench.py:191-217``): CCD++ on
the panel-hybrid backend at Netflix-100M dims, ``synthetic_cached(480189,
17770, 100_000_000, seed=1, test_fraction=0.02)``, k = 40, λ = 0.05, a
bfloat16 residual with NaN sentinels, the panel kernels K1 and K2, the hand
stair (4096, 2048) under 6.5e9 cells. ``--m --n --nnz --k --budget`` shrink
it for tests.

Metric: ``ccd_netflix_scale_throughput``, M rating-updates/s = nnz · k /
(median s/iter). The run is ``ccd_hybrid_train`` (the path ``train()``
runs), so each outer iteration is timed as the trainer times it, on the
host clock around the step and its on-device RMSE up to
``torch.cuda.synchronize()``; the median is over ``--iters`` steady
iterations after ``--warmup`` others (the samples, min/max and spread ride
along), and the test RMSE is the last iteration's
(``eval/metrics.py::calrmse_device``).

In the same run, with the run's training state freed, the controls are
measured on the card: P1's stream controls (``scripts/panel_floor.py``:
rmw and read, in 16-byte vectors) at each of the run's panel shapes, and
P3's gathers
(``scripts/probe_gather.py``) at each ELL tail side's shape. Then

* ``vs_baseline`` = ideal / measured s/iter, the ideal being k · (panel
  cells · 6 B (K1 reads and writes 2 B a cell, K2 reads 2) + the tail's
  bytes) over 3.35 TB/s. The tail's bytes count ``ops/ell_ops.py::
  fused_update_sweep`` with each input read once and each output written
  once: per padded lane its int64 index and its f32 value read and written
  (16 B), per slot two own-vectors read and g, h written (16 B), the
  gathered table once. A ratio of the least time to the measured one, so
  never above 1.
* ``detail.vs_baseline_achievable`` = k · (Σ over panels of the
  ACHIEVABLE controls' times: the rmw ("rmw", K1's bytes) and the read
  ("read", K2's bytes) + Σ over tail sides of the padded lanes at gather
  form B's measured time per element) / measured s/iter: a diagnostic
  against what the card's plain streams reach, not a roofline share.

Without a card the run exits non-zero unless ``--device cpu`` is given;
a CPU record names the CPU as its device and carries ``vs_baseline: null``
and no measured control.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .core.config import Config
from .core.device import resolve_device
from .core.init import init_factors_np
from .data.datasets import synthetic_cached
from .ops import launches
from .scripts.common import PEAK_BYTES_S, card
from .scripts.panel_floor import CONTROLS, panel_modes
from .scripts.probe_gather import gather_probe, tail_shape
from .solvers import ccd_hybrid as ch

METRIC = "ccd_netflix_scale_throughput"
UNIT = "M rating-updates/s/chip"
#: the JAX package's headline (bench.py:191-217)
HEADLINE = dict(m=480_189, n=17_770, nnz=100_000_000, k=40, lam=0.05,
                budget=6_500_000_000, widths="4096,2048", seed=1)
#: bytes a panel cell costs per rank: K1 reads and writes it, K2 reads it
PANEL_BYTES_PER_CELL = 6
#: bytes of fused_update_sweep per padded lane (int64 index, f32 value
#: read and written) and per slot (two own-vectors read, g and h written)
TAIL_BYTES_PER_LANE = 8 + 4 + 4
TAIL_BYTES_PER_SLOT = 4 * 4
#: the panel controls that stand for what the card reaches: K1's bytes
#: at the rmw's time, K2's at the read's
ACHIEVABLE = ("rmw", "read")
#: floats gathered per lane: rows side (v_pend, v_old, v), cols side
#: (u_pend, u_old)
TAIL_WIDTH = {"rows": 3, "cols": 2}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.bench",
        description="the port's CCD++ panel-hybrid benchmark (one JSON "
                    "line)")
    p.add_argument("--panel-widths", default=HEADLINE["widths"],
                   metavar="auto|W1,W2,...",
                   help="hybrid stair widths (default: the hand stair "
                        "4096,2048), or 'auto' for the data-driven stair")
    p.add_argument("--transpose", default="0", choices=["0", "1", "auto"],
                   help="stair orientation: 0 users as rows, 1 the "
                        "transposed matrix, auto the smaller tail")
    p.add_argument("--iters", type=int, default=5,
                   help="timed outer iterations (the median's samples)")
    p.add_argument("--warmup", type=int, default=2,
                   help="untimed outer iterations before them")
    p.add_argument("--m", type=int, default=HEADLINE["m"])
    p.add_argument("--n", type=int, default=HEADLINE["n"])
    p.add_argument("--nnz", type=int, default=HEADLINE["nnz"])
    p.add_argument("--k", type=int, default=HEADLINE["k"])
    p.add_argument("--budget", type=int, default=HEADLINE["budget"],
                   help="panel-stair cell budget")
    p.add_argument("--seed", type=int, default=HEADLINE["seed"],
                   help="the synthetic data's seed")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    return p


def config(args) -> Config:
    widths = ("auto" if args.panel_widths == "auto" else
              tuple(int(w) for w in args.panel_widths.split(",") if w))
    transpose = ("auto" if args.transpose == "auto"
                 else bool(int(args.transpose)))
    return Config(k=args.k, lambda_=HEADLINE["lam"],
                  maxiter=args.warmup + args.iters,
                  backend="hybrid", residual_dtype="bfloat16",
                  mask_dtype="nan", hybrid_panel_kernel=True,
                  hybrid_dense_cells=args.budget, hybrid_panel_widths=widths,
                  hybrid_transpose=transpose)


def tail_sides(plan: ch.HybridPlan) -> dict:
    """Per ELL side: padded lanes, slots, and the table it gathers from
    (the other side's entities plus the zero slot, TAIL_WIDTH floats)."""
    m, n = plan.row_nnz.shape[0], plan.col_nnz.shape[0]
    out = {}
    for name, side, other in (("rows", plan.ell.rows_side, n),
                              ("cols", plan.ell.cols_side, m)):
        out[name] = {"lanes": int(sum(b.idx.size for b in side.buckets)),
                     "slots": int(side.n_slots) if side.buckets else 0,
                     "table_rows": other + 1, "width": TAIL_WIDTH[name]}
    return out


def tail_bytes(sides: dict) -> int:
    return sum(s["lanes"] * TAIL_BYTES_PER_LANE + s["slots"]
               * TAIL_BYTES_PER_SLOT + s["table_rows"] * s["width"] * 4
               for s in sides.values() if s["lanes"])


def train_and_time(R, T, cfg: Config, dev, warmup: int) -> dict:
    """Train ``cfg.maxiter`` outer iterations through ``ccd_hybrid_train``
    (the path ``train()`` runs, which plans in the orientation ``cfg``
    asks for); the samples are the iterations after ``warmup``, the RMSE
    the last one's, the launch counts the run's, the plan and orientation
    the ones the run chose."""
    W0, H0 = init_factors_np(cfg.k, R.rows, R.cols, seed=cfg.seed)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    launches.reset_launch_counts()
    run: dict = {}
    _, _, stats = ch.ccd_hybrid_train(R, W0, H0, T, cfg, device=dev, run=run)
    counts = launches.launch_counts()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(plan=run["plan"], transposed=run["transposed"],
                samples=[st.rank_time for st in stats[warmup:]],
                launches=counts, rmse=stats[-1].rmse, peak=peak,
                plan_s=run["plan_s"], setup_s=run["setup_s"])


def controls(plan: ch.HybridPlan, sides: dict, dev) -> dict:
    """P1's stream controls at each panel shape and P3's gathers at each
    tail side's shape, with their launch counts."""
    launches.reset_launch_counts()
    panels = panel_modes([(r1 - r0, w) for r0, r1, w in plan.panels], dev,
                         modes=CONTROLS)
    gathers = {}
    for name, s in sides.items():
        if s["lanes"]:
            S, rows = tail_shape(s["lanes"], s["table_rows"], s["width"])
            gathers[name] = gather_probe(S, rows, dev, library=False)
    return {"panels": panels, "gathers": gathers,
            "launches": launches.launch_counts()}


def achievable_s(k: int, ctl: dict, sides: dict) -> float | None:
    """Per outer iteration: k · (Σ panels of the ACHIEVABLE controls' ms +
    Σ sides lanes · form B's time per element), in seconds; None if
    unmeasured."""
    ms = 0.0
    for rec in ctl["panels"]:
        parts = [rec[m]["ms"] for m in ACHIEVABLE]
        if None in parts:
            return None
        ms += sum(parts)
    for name, g in ctl["gathers"].items():
        ns = g["B"]["ns_per_element"]
        if ns is None:
            return None
        ms += sides[name]["lanes"] * ns / 1e6
    return k * ms / 1e3


def run(args, data=None) -> dict:
    """The benchmark record of ``args``. ``data``: the (R, T) of
    ``synthetic_cached(args.m, args.n, args.nnz, seed=args.seed,
    test_fraction=0.02)`` when the caller has it loaded already (several
    runs in one process share one load; ``host_s.data`` is then 0)."""
    dev = resolve_device(args.device)
    cfg = config(args)
    t0 = time.perf_counter()
    R, T = data or synthetic_cached(args.m, args.n, args.nnz, seed=args.seed,
                                    test_fraction=0.02)
    data_s = time.perf_counter() - t0
    res = train_and_time(R, T, cfg, dev, args.warmup)
    plan, samples = res["plan"], res["samples"]
    sides = tail_sides(plan)
    ctl = controls(plan, sides, dev)

    dt = statistics.median(samples)
    k = cfg.k
    panel_cells = sum((r1 - r0) * w for r0, r1, w in plan.panels)
    ideal_s = k * (panel_cells * PANEL_BYTES_PER_CELL
                   + tail_bytes(sides)) / PEAK_BYTES_S
    on_card = dev.type == "cuda"
    achv = achievable_s(k, ctl, sides)
    return {
        "metric": METRIC,
        "value": R.nnz * k / dt / 1e6,
        "unit": UNIT,
        "vs_baseline": ideal_s / dt if on_card else None,
        "detail": {
            "dataset": f"synthetic_cached({args.m}, {args.n}, {args.nnz}, "
                       f"seed={args.seed}, test_fraction=0.02): train nnz "
                       f"{R.nnz}, test nnz {T.nnz}",
            "backend": "hybrid: NaN-sentinel bf16 panels through K1/K2 + "
                       "the padded-ELL tail",
            "k": k, "lambda": cfg.lambda_, "budget": args.budget,
            "panel_widths": args.panel_widths,
            "transpose": args.transpose,
            "orientation": ("transposed (items as rows)" if res["transposed"]
                            else "users as rows"),
            "panels": [list(p) for p in plan.panels],
            "panel_cells": panel_cells,
            "nnz_light_frac": plan.nnz_light / R.nnz,
            "tail": sides,
            "outer_iter_s": dt,
            "timing": "host clock around one outer iteration and its RMSE "
                      "ending in torch.cuda.synchronize(); median of "
                      f"{args.iters} after {args.warmup} warm-up iterations",
            "iter_s_samples": samples,
            "iter_s_min_max": [min(samples), max(samples)],
            "iter_s_spread_pct": 100.0 * (max(samples) - min(samples)) / dt,
            "warmup": args.warmup, "iters": args.iters,
            "test_rmse": res["rmse"],
            "iterations_run": args.warmup + args.iters,
            "peak_device_memory_bytes": res["peak"],
            "launches": res["launches"],
            "ideal_s_per_iter": ideal_s,
            "baseline_def": f"ideal: k x (panel cells x "
                            f"{PANEL_BYTES_PER_CELL} B + tail bytes) / "
                            f"{PEAK_BYTES_S / 1e12} TB/s over the measured "
                            "s/iter",
            "vs_baseline_achievable": (achv / dt if on_card and achv
                                       else None),
            "achievable_def": f"k x (per panel: the {' + '.join(ACHIEVABLE)}"
                              " controls; per tail side: "
                              "padded lanes x gather form B's time per "
                              "element) over the measured s/iter",
            "controls": ctl,
            "host_s": {"data": data_s, "plan": res["plan_s"],
                       "device_setup": res["setup_s"]},
            "device": card(dev),
        },
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    print(json.dumps(run(args)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
