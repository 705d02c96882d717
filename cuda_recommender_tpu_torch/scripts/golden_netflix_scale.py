"""The golden cross-check at the headline's own size (the port of
``scripts/golden_netflix_scale.py``): Netflix-100M, k = 40, the NaN-sentinel
panel hybrid with the panel kernels (K1, K2) against the NumPy golden
solver from the same seed-0 init, 3 outer iterations.

    python -m cuda_recommender_tpu_torch.scripts.golden_netflix_scale \\
        [float32|bfloat16|float32,bfloat16] [--out-dir DIR] [--device cuda]

The workload is ``synthetic_cached(480189, 17770, 100_000_000, seed=1,
test_fraction=0.02)``, ``init_factors_np(40, m, n, seed=0)``, λ = 0.05;
the config the JAX script's: hybrid, NaN mask, hand stair (4096, 2048)
under 6.5e9 cells, panel kernels on. Each residual dtype given trains in
turn on the card; then ``solvers/reference.py::ccd_reference`` runs once
on the host (it cannot resume, and it is the expensive part: its 3
iterations took 1154-1535 s beside the JAX runs) and every dtype is held
against it: ``golden_compare(atol=1e-3)`` on W and H, and the RMSE an
iteration. Where entries miss the bar, the record carries the
determination histogram (``determination_histogram``, the JAX script's).

Writes ``golden_netflix_100m_<dtype>.json`` per dtype to ``--out-dir``
(default ``cuda_recommender_tpu_torch/results/``) with the JAX record's
keys, ``hardware`` the card's name and power limit, ``train_s`` this
run's seconds, and ``rmse_golden_jax``, the JAX record's golden RMSEs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device
from ..core.init import init_factors_np
from ..data.datasets import synthetic_cached
from ..eval.metrics import golden_compare
from ..ops import launches
from ..solvers.ccd_hybrid import ccd_hybrid_train
from ..solvers.reference import ccd_reference
from .common import card
from .run_trajectories import OUT_DIR

ITERS = 3
#: the JAX script's workload: (m, n, nnz, k, λ)
NETFLIX = (480_189, 17_770, 100_000_000, 40, 0.05)
#: the JAX records' golden RMSEs (results/golden_netflix_100m_r4.json,
#: results/golden_netflix_100m_bf16_r5.json): the same NumPy solver on the
#: same data and init
RMSE_GOLDEN_JAX = [0.372174, 0.37114, 0.337164]
DTYPES = ("float32", "bfloat16")
#: |hybrid RMSE - golden RMSE| an iteration: f32 tracks the golden run,
#: bf16 within the repo's bf16 trajectory bar; f32 must also pass
#: golden_compare on W and H
RMSE_TOL = {"float32": 1e-3, "bfloat16": 0.02}
#: |golden RMSE - the JAX record's| an iteration (the records hold six
#: decimals)
GOLDEN_JAX_TOL = 1e-5


def determination_histogram(A, A_ref, deg, rtol=0.10):
    """Failure anatomy for the 10% bar: fail-rate by entity-nnz decile and
    by |golden entry| decile, plus the conditional bar among entries whose
    golden magnitude is above the median AND whose entity has >= the
    median nnz. A (k, n_ent); deg (n_ent,)."""
    A = np.asarray(A, np.float64)
    G = np.asarray(A_ref, np.float64)
    fail = (np.abs(A - G) > rtol * np.abs(G)).ravel()
    mag = np.abs(G).ravel()
    degs = np.broadcast_to(np.asarray(deg, np.float64), A.shape).ravel()
    out = {}
    for name, key in (("by_entity_nnz", degs), ("by_abs_entry", mag)):
        edges = np.quantile(key, np.linspace(0, 1, 11))
        edges[-1] += 1
        which = np.clip(np.searchsorted(edges, key, "right") - 1, 0, 9)
        rates, los = [], []
        for b in range(10):
            sel = which == b
            rates.append(round(float(fail[sel].mean()) if sel.any() else 0.0,
                               5))
            los.append(round(float(edges[b]), 6))
        out[name] = {"decile_lo": los, "fail_rate": rates}
    well = (mag >= np.median(mag)) & (degs >= np.median(degs))
    out["conditional_bar"] = {
        "definition": "entries with |golden| >= median AND entity nnz >= "
                      "median",
        "n": int(well.sum()),
        "fail_rate": round(float(fail[well].mean()), 6),
        "fail_rate_overall": round(float(fail.mean()), 6),
    }
    return out


def config(rdt: str, k: int, lam: float, budget: int, widths) -> Config:
    return Config(k=k, maxiter=ITERS, lambda_=lam, backend="hybrid",
                  residual_dtype=rdt, mask_dtype="nan",
                  hybrid_dense_cells=budget, hybrid_panel_widths=widths,
                  hybrid_panel_kernel=True)


def main(argv=None, *, dims=NETFLIX, budget: int = 6_500_000_000,
         widths=(4096, 2048)) -> int:
    """``dims`` (m, n, nnz, k, λ), ``budget`` and ``widths`` are the
    headline's unless a caller (the CPU tests) shrinks them."""
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.golden_netflix_scale",
        description="the hybrid against the NumPy golden solver at "
                    "Netflix-100M")
    p.add_argument("dtypes", nargs="?", default="bfloat16",
                   help="residual dtype(s), comma-separated: float32, "
                        "bfloat16")
    p.add_argument("--out-dir", default=OUT_DIR)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dtypes = args.dtypes.split(",")
    if not set(dtypes) <= set(DTYPES):
        p.error(f"dtypes must be among {DTYPES}")
    dev = resolve_device(args.device)
    where = card(dev)
    os.makedirs(args.out_dir, exist_ok=True)
    m, n, nnz, k, lam = dims
    t0 = time.perf_counter()
    R, T = synthetic_cached(m, n, nnz, seed=1, test_fraction=0.02)
    print(f"data {m}x{n} nnz {R.nnz} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    W0, H0 = init_factors_np(k, m, n, seed=0)

    runs = {}
    for rdt in dtypes:
        launches.reset_launch_counts()
        t0 = time.perf_counter()
        Wc, Hc, sc = ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                      config(rdt, k, lam, budget, widths),
                                      device=dev)
        t_dev = time.perf_counter() - t0
        counts = {name: c for name, c in launches.launch_counts().items()
                  if c}
        if dev.type == "cuda" and not (counts.get("panel_update_vsweep")
                                       and counts.get("panel_usweep")):
            raise AssertionError(f"{rdt}: K1 and K2 did not both launch: "
                                 f"{counts}")
        runs[rdt] = (Wc, Hc, sc, t_dev)
        print(f"hybrid {rdt} {ITERS} iters in {t_dev:.0f}s, rmse "
              f"{[round(s.rmse, 5) for s in sc]}, launches {counts}",
              flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    Wg, Hg = W0.copy(), H0.copy()
    t0 = time.perf_counter()
    sg = ccd_reference(R, Wg, Hg, T, lambda_=lam, maxiter=ITERS,
                       maxinneriter=1, callback=lambda st: print(
                           f"golden iteration {st.oiter}: rmse {st.rmse:.6f}"
                           f" at {time.perf_counter() - t0:.0f}s", flush=True))
    t_cpu = time.perf_counter() - t0
    print(f"golden {ITERS} iters in {t_cpu:.0f}s, rmse "
          f"{[round(s.rmse, 5) for s in sg]}", flush=True)

    misses = []
    if dims == NETFLIX:
        off = max(abs(a.rmse - b) for a, b in zip(sg, RMSE_GOLDEN_JAX))
        print(f"golden against the JAX record's: max |diff| {off:.2e} (bar "
              f"{GOLDEN_JAX_TOL})", flush=True)
        if off > GOLDEN_JAX_TOL:
            misses.append(f"golden RMSE {off:.2e} off the JAX record's")
    for rdt, (Wc, Hc, sc, t_dev) in runs.items():
        gw = golden_compare(Wc, Wg, atol=1e-3)
        gh = golden_compare(Hc, Hg, atol=1e-3)
        rec = {
            "workload": f"golden cross-check at Netflix-100M k={k}: {rdt} "
                        "NaN-sentinel panel-kernel hybrid vs NumPy golden, "
                        f"{ITERS} outer iters from identical seed-0 init"
                        + ("" if dims == NETFLIX else
                           f" (cut to {m}x{n}, nnz {nnz}, k={k})"),
            "rmse_hybrid": [round(s.rmse, 6) for s in sc],
            "rmse_golden": [round(s.rmse, 6) for s in sg],
            "rmse_golden_jax": RMSE_GOLDEN_JAX,
            "golden_W": {"passed": bool(gw.passed),
                         "err_pct": round(gw.error_percentage, 5)},
            "golden_H": {"passed": bool(gh.passed),
                         "err_pct": round(gh.error_percentage, 5)},
            "tolerance": "10% relative per entry (src/extras.cpp:223)",
            "train_s": {"hybrid": round(t_dev, 1),
                        "golden_numpy": round(t_cpu, 1)},
            "residual_dtype": rdt,
            "hardware": where,
        }
        if not (gw.passed and gh.passed):
            rec["determination_histogram_W"] = determination_histogram(
                Wc, Wg, R.row_nnz)
            rec["determination_histogram_H"] = determination_histogram(
                Hc, Hg, R.col_nnz)
        path = os.path.join(args.out_dir, f"golden_netflix_100m_{rdt}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        print("RESULT " + json.dumps(rec), flush=True)
        gap = max(abs(a.rmse - b.rmse) for a, b in zip(sc, sg))
        print(f"{rdt}: golden W {gw.message()} H {gh.message()}; max |RMSE "
              f"- golden| {gap:.2e} (bar {RMSE_TOL[rdt]})", flush=True)
        if gap > RMSE_TOL[rdt] or (rdt == "float32" and not (
                gw.passed and gh.passed)):
            misses.append(f"{rdt}: golden W {gw.passed}, H {gh.passed}, "
                          f"RMSE gap {gap:.2e}")
    for miss in misses:
        print(f"MISS {miss}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
