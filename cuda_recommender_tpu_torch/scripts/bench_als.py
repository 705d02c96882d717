"""The ALS measurements of the JAX package's ``scripts/bench_als_tpu.py``:
the ml20M step at each gram precision, and the ml1m golden check of the
bf16 precisions.

    python -m cuda_recommender_tpu_torch.scripts.bench_als [k=40] \\
        [--out FILE] [--device cuda]

1. **Step time** (``bench_als_tpu.py:40-74``, ``76-88``): the ALS outer
   step at ml20M dims (138,493 x 26,744, 20 M ratings, seed 1), k, λ = 0.1,
   solver gj (K5), built and timed by ``scripts/profile_iteration.py``
   (``als_step``, ``profile_split``): four untraced steps, each fenced by
   ``torch.cuda.synchronize()``, then one under torch.profiler; ``iter_s``
   is the median of the last three untraced steps, and each precision's
   profiled step is split into the gram products, the gathers, K5 and the
   rest. At k = 40 the precisions "highest", "high" and "default" (the
   JAX script times the first two: "default" was not accurate on the TPU);
   at another k (the k = 128 row) "highest" only, and the record is the
   JAX script's short one.
2. **Golden** (``bench_als_tpu.py:90-119``, k = 40 only):
   ``ml1m_like(seed=0)``, k = 10, λ = 0.05, 10 outer iterations fused 10 to
   a launch group, through ``solvers/als_ell.py::als_ell_train`` against
   the NumPy ``als_reference`` from the same seed-0 init, at "high" and at
   "default". ``golden_compare`` at atol 1e-3 on W and H. "high" must pass
   on both and end within ``RMSE_TOL`` of its golden run's RMSE and of the
   JAX record's (``results/als_ml20m_r2.json``: 0.77652); "default" must
   end within ``DEFAULT_RMSE_TOL`` of the golden RMSE (the JAX package's
   bar for it, ``tests/test_compiled_solvers.py:146-155``). A miss exits
   1. "default" is also held to the JAX package's per-entry ALS bar, under
   ``DEFAULT_GOLDEN_PCT`` of W's and of H's entries off
   (``tests/test_trainer.py:29-34``), and the verdict recorded
   (``default_within_als_bar``) whatever it is: one bf16 pass rounds the
   factor tables to 8 bits, and on the CPU (the same rounding, f32 sums)
   5.44% of H's entries miss the 10% bar at an RMSE 7e-6 from the golden's.

One JSON line ``RESULT {...}`` with the JAX script's keys, plus
``iter_s_default``, ``default_golden_*``, ``ml1m_rmse_default_vs_golden``,
each precision's busy split and ``card`` (the card's name and power limit);
also written to ``--out`` (default ``cuda_recommender_tpu_torch/results/
bench_als.json``; none with ``--out ''``). ``round1_baseline_s`` is null:
the JAX record's value is a TPU time. With ``--device cpu`` part 1 runs at
``CPU_DIMS`` and every time is null ("not measured").
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
from ..data.datasets import ml1m_like
from ..eval.metrics import calrmse_np, golden_compare
from ..ops import launches
from ..solvers.als_ell import als_ell_train
from ..solvers.reference import als_reference
from .common import card
from .profile_iteration import ALS, als_step, kernel_split, profile_split
from .run_trajectories import OUT_DIR

#: ml20M dims (bench_als_tpu.py:78), λ = 0.1
DIMS = {key: ALS[key] for key in ("m", "n", "nnz")}
LAM = 0.1
#: --device cpu: part 1 at these dims
CPU_DIMS = dict(m=3000, n=800, nnz=60_000)
#: untraced steps before the profiled one; the first pays the first
#: launches and is not a sample
WARM = 4
#: part 2 (bench_als_tpu.py:90-100)
GOLDEN = dict(k=10, lam=0.05, maxiter=10, fused=10)
GOLDEN_PRECISIONS = ("high", "default")
#: the JAX record's RMSE of "high" on the ml1m fixture after 10 iterations
#: (results/als_ml20m_r2.json, ml1m_rmse_high_vs_golden[0])
RMSE_HIGH_JAX = 0.77652
#: "high": |RMSE - golden run's| and |RMSE - RMSE_HIGH_JAX| allowed
RMSE_TOL = 1e-4
#: "default": |RMSE - the golden run's| allowed
DEFAULT_RMSE_TOL = 0.01
#: "default": the per-entry ALS bar, the share of W's and of H's entries
#: (%) off golden_compare's, recorded
DEFAULT_GOLDEN_PCT = 1.0
OUT = os.path.join(OUT_DIR, "bench_als.json")


def time_step(k: int, precision: str, dev, dims=None) -> dict:
    """Part 1 at one precision: s/iter (None on the CPU), the profiled
    step's busy ms by part, and the K5 launches of the profiled step."""
    step, what = als_step(dev, **(dims or DIMS), k=k, lam=LAM,
                          precision=precision)
    launches.reset_launch_counts()
    out = profile_split(step, dev, warm=WARM)
    per_step = launches.launch_counts()["gj_solve"] // (WARM + 1)
    del step
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        if not per_step:
            raise AssertionError(f"{what}: K5 never launched")
    iter_s = statistics.median(out["untraced_s"][1:]) if on_card else None
    print(f"[bench_als] {what}: "
          + (f"{iter_s * 1e3:.3f} ms/iter, busy {out['busy_ms']:.3f} ms"
             if on_card else "not timed on the CPU"), flush=True)
    return {"iter_s": iter_s,
            "untraced_s": out["untraced_s"] if on_card else None,
            "busy_ms": out["busy_ms"] if on_card else None,
            "idle_pct": out["idle_pct"] if on_card else None,
            "busy_ms_by_part": kernel_split(out) if on_card else None,
            "k5_launches_per_iter": per_step}


def golden_run(precisions=GOLDEN_PRECISIONS, dev="cuda", *,
               maxiter: int = GOLDEN["maxiter"]) -> dict:
    """Part 2: the ml1m fixture at each of ``precisions`` through
    ``als_ell_train`` against one ``als_reference`` run from the same
    init. {"golden_rmse", precision: {"W", "H" (GoldenResults), "rmse",
    "launches"}}."""
    dev = resolve_device(dev)
    R, T = ml1m_like(seed=0)
    k, lam = GOLDEN["k"], GOLDEN["lam"]
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=0, entity_major=True)
    out = {}
    for prec in precisions:
        cfg = Config(solver="als", k=k, maxiter=maxiter, lambda_=lam,
                     als_precision=prec, fused_outer_iters=GOLDEN["fused"])
        launches.reset_launch_counts()
        Wc, Hc, _ = als_ell_train(R, W0.copy(), H0.copy(), T, cfg,
                                  device=dev)
        counts = {name: n for name, n in launches.launch_counts().items()
                  if n}
        if dev.type == "cuda" and not counts.get("gj_solve"):
            raise AssertionError(f"ALS at {prec!r}: K5 never launched")
        out[prec] = {"Wc": Wc, "Hc": Hc, "launches": counts,
                     "rmse": calrmse_np(T, Wc, Hc, entity_major=True)}
    t0 = time.perf_counter()
    Wg, Hg = W0.copy(), H0.copy()
    sg = als_reference(R, Wg, Hg, T, lambda_=lam, maxiter=maxiter)
    out["golden_rmse"] = sg[-1].rmse
    out["golden_s"] = time.perf_counter() - t0
    for prec in precisions:
        run = out[prec]
        run["W"] = golden_compare(run.pop("Wc"), Wg, atol=1e-3)
        run["H"] = golden_compare(run.pop("Hc"), Hg, atol=1e-3)
        print(f"[bench_als] ml1m {prec} golden: W {run['W'].message()} H "
              f"{run['H'].message()} rmse {run['rmse']:.6f} vs golden "
              f"{out['golden_rmse']:.6f}; launches {run['launches']}",
              flush=True)
    return out


def golden_misses(gold: dict, *, jax_rmse: float | None = RMSE_HIGH_JAX
                  ) -> list:
    """"high" passes on W and H and ends within RMSE_TOL of its golden
    run's RMSE and of ``jax_rmse`` (the JAX record's; None: not held);
    "default" ends within DEFAULT_RMSE_TOL of the golden RMSE."""
    misses = []
    bars = {"high": RMSE_TOL, "default": DEFAULT_RMSE_TOL}
    for prec in [p for p in GOLDEN_PRECISIONS if p in gold]:
        run = gold[prec]
        refs = {"its golden run": gold["golden_rmse"]}
        if prec == "high":
            misses += [f"high: golden_{side} {run[side].message()}"
                       for side in ("W", "H") if not run[side].passed]
            if jax_rmse is not None:
                refs["the JAX record"] = jax_rmse
        for what, ref in refs.items():
            diff = round(abs(run["rmse"] - ref), 9)
            if diff > bars[prec]:
                misses.append(f"{prec}: RMSE {run['rmse']:.6f}, {diff} off "
                              f"{what}'s {ref} (bar {bars[prec]})")
    return misses


def within_als_bar(run: dict) -> bool:
    """Under DEFAULT_GOLDEN_PCT of W's and of H's entries off."""
    return all(run[side].error_percentage < DEFAULT_GOLDEN_PCT
               for side in ("W", "H"))


def result(k: int, steps: dict, gold: dict | None, where: dict) -> dict:
    """The RESULT record: the JAX script's keys (its short one at k != 40)
    and the port's."""
    rec = {"workload": f"als ml20M k={k} (batch-last GJ)",
           "iter_s_highest": steps["highest"]["iter_s"]}
    if gold is None:
        it = steps["highest"]["iter_s"]
        rec["ratings_per_s_M"] = DIMS["nnz"] / it / 1e6 if it else None
    else:
        high, default = gold["high"], gold["default"]
        rec.update({
            "iter_s_high": steps["high"]["iter_s"],
            "round1_baseline_s": None,
            "high_golden_W_pass": high["W"].passed,
            "high_golden_H_pass": high["H"].passed,
            "high_golden_err_pct": max(high["W"].error_percentage,
                                       high["H"].error_percentage),
            "ml1m_rmse_high_vs_golden": [high["rmse"], gold["golden_rmse"]],
            "iter_s_default": steps["default"]["iter_s"],
            "default_golden_W_pass": default["W"].passed,
            "default_golden_H_pass": default["H"].passed,
            "default_golden_W_err_pct": default["W"].error_percentage,
            "default_golden_H_err_pct": default["H"].error_percentage,
            "default_within_als_bar": within_als_bar(default),
            "ml1m_rmse_default_vs_golden": [default["rmse"],
                                            gold["golden_rmse"]],
            "ml1m_rmse_high_jax": RMSE_HIGH_JAX,
            "golden_launches": {prec: gold[prec]["launches"]
                                for prec in GOLDEN_PRECISIONS},
            "golden_reference_s": gold["golden_s"]})
    rec["steps"] = steps
    rec["card"] = where
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.bench_als",
        description="the ALS step at ml20M dims by gram precision, and the "
                    "ml1m golden check of 'high' and 'default'")
    p.add_argument("k", nargs="?", type=int, default=40)
    p.add_argument("--out", default=OUT,
                   help="JSON file of the record ('' for none)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench_als: {e}; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    dims = CPU_DIMS if dev.type == "cpu" else None
    precisions = (("highest", "high", "default") if args.k == 40
                  else ("highest",))
    steps = {prec: time_step(args.k, prec, dev, dims) for prec in precisions}
    gold = golden_run(dev=dev) if args.k == 40 else None
    misses = golden_misses(gold) if gold else []
    rec = result(args.k, steps, gold, card(dev))
    print("RESULT " + json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
            f.write("\n")
    for miss in misses:
        print(f"MISS {miss}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
