"""RMSE trajectories on the ml-1m-calibrated fixture through the whole
pipeline, against the NumPy golden solvers and the JAX package's records
(the port of ``scripts/run_trajectories.py``).

    python -m cuda_recommender_tpu_torch.scripts.run_trajectories \\
        [maxiter=15] [workdir=a temp dir] [outdir] [--device cuda]

The fixture (``data/datasets.py::ml1m_like(seed=0)``) is written as text
ratings, converted by ``cli/convert.py`` (the native parser; 10% test,
seed 0) and read back by ``data/binfmt.py::load_binary_dataset``; a
``workdir`` that already holds the converted dataset is reused. Then, from
the seed-0 init, k = 10, λ = 0.05, in the JAX script's order:

* ``ccd``: CCD++ at AUTO (dense at these dims: K4 and ``masked_usweep``)
  against ``ccd_reference``;
* ``hybrid_bf16_int8``: the hybrid at a bf16 residual and an int8 mask
  (K4 and the masked sweeps), budget 2000 · n cells;
* ``hybrid_fp8``: the hybrid at an fp8 e4m3fn residual and an int8 mask
  (the fp8 instances of K4, delta-first as the JAX einsum path stores, and
  of the masked sweeps); its golden check is reported, not required (the
  JAX record itself misses it: 84.6% / 83.8% of W / H off);
* ``hybrid_bf16_nan_kernel``: bf16 NaN-sentinel panels with the panel
  kernels (K1 and K2);
* ``als``: ALS at AUTO (ELL, solver gj: K5) against ``als_reference``.

Each arm writes ``rmse_trajectory_ml1m_<arm>.jsonl`` to ``outdir``
(default ``cuda_recommender_tpu_torch/results/``): one line per outer
iteration ``{oiter, rmse_compiled, rmse_golden}`` and a ``summary`` line
with the JAX script's keys (``device`` is the card's name and power limit,
``scripts/common.py::card``). The hybrids share the CCD arm's golden run.

Then every arm is held against the JAX package's committed record
(``results/rmse_trajectory_ml1m_<arm>.jsonl`` at the repo root),
iteration by iteration, at the bars in ``BARS``; a
line per iteration prints both. Each arm is also held to its golden run:
dense CCD++ passes ``golden_compare`` (atol 1e-3) on W and H, ALS has
under ``ALS_GOLDEN_PCT`` of entries off, and each bf16 hybrid's RMSE lies
within ``HYBRID_GOLDEN_GAP`` of the golden's at every iteration (the fp8
arm's gap is printed, not held). A miss exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..cli.convert import main as convert_main
from ..core.config import Config
from ..core.device import resolve_device
from ..core.init import init_factors_np
from ..data import binfmt
from ..data.datasets import ml1m_like
from ..eval.metrics import golden_compare
from ..models.mf import get_train_fn
from ..ops import launches
from ..solvers.reference import als_reference, ccd_reference
from .common import card

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: where the records go unless the caller names a directory
OUT_DIR = os.path.join(PACKAGE, "results")
#: the JAX package's committed records
JAX_RECORDS = os.path.join(os.path.dirname(PACKAGE), "results")
DATASET = "ml1m_like(seed=0) via convert->binfmt"
K, LAM = 10, 0.05
#: the hybrid arms: (tag, residual dtype, mask dtype, panel kernels)
HYBRIDS = (("bf16_int8", "bfloat16", "int8", False),
           ("fp8", "float8_e4m3fn", "int8", False),
           ("bf16_nan_kernel", "bfloat16", "nan", True))
#: the kernels each arm must launch on the card
WANT_KERNELS = {
    "ccd": ("fused_update_vsweep", "masked_usweep"),
    "hybrid_bf16_int8": ("fused_update_vsweep", "masked_usweep"),
    "hybrid_fp8": ("fused_update_vsweep_fp8_delta_first",
                   "masked_usweep_fp8"),
    "hybrid_bf16_nan_kernel": ("panel_update_vsweep", "panel_usweep"),
    "als": ("gj_solve",)}
#: |port - JAX record| allowed per iteration: (rmse_compiled, rmse_golden).
#: The goldens are the same NumPy solver on the same data (1e-6 CCD, 1e-5
#: ALS); the compiled f32 runs track the JAX run within 1e-3, the bf16
#: and fp8 hybrids within the repo's narrow-residual trajectory bar, 0.02
BARS = {"ccd": (1e-3, 1e-6), "hybrid_bf16_int8": (0.02, 1e-6),
        "hybrid_fp8": (0.02, 1e-6), "hybrid_bf16_nan_kernel": (0.02, 1e-6),
        "als": (1e-3, 1e-5)}
#: ALS: the share of W's and of H's entries (%) allowed off golden_compare's
#: bar, the trainer tests' bar for ALS against its reference
ALS_GOLDEN_PCT = 1.0
#: the bf16 hybrids: |rmse_compiled - rmse_golden| allowed at any iteration.
#: The gap grows with the iterations; the largest measured at 15 is 6.29e-4
#: (NaN panels on an H100) and 6.16e-4 (the JAX record), so 1e-3 leaves a
#: margin of 1.6x, while a kernel error of 1% of the RMSE (7e-3) misses it
HYBRID_GOLDEN_GAP = 1e-3


def fixture(work: str):
    """ml1m_like(seed=0) -> text ratings -> cli/convert -> binfmt, as the
    JAX script builds it (a converted dataset in ``work`` is reused;
    ``work`` is made if missing)."""
    bin_dir = os.path.join(work, "bin")
    if not os.path.exists(os.path.join(bin_dir, "meta_modified_all")):
        os.makedirs(work, exist_ok=True)
        R0, T0 = ml1m_like(seed=0)
        ri, ci, vv = R0.to_coo()
        rows = np.concatenate([ri, T0.row_idx]) + 1
        cols = np.concatenate([ci, T0.col_idx]) + 1
        vals = np.concatenate([vv, T0.val])
        txt = os.path.join(work, "ratings.txt")
        # the JAX script's f"{a + 1} {b + 1} {x:.0f}" lines: the ratings
        # lie on the 1..5 grid
        np.savetxt(txt, np.stack([rows, cols, np.rint(vals).astype(np.int64)],
                                 axis=1), fmt="%d")
        convert_main([txt, bin_dir, "--test-fraction", "0.1", "--seed", "0"])
    return binfmt.load_binary_dataset(bin_dir)


def _lines(stats, golden) -> list:
    return [{"oiter": a.oiter, "rmse_compiled": round(a.rmse, 6),
             "rmse_golden": round(b.rmse, 6)} for a, b in zip(stats, golden)]


def _train(arm, cfg, backend, R, W0, H0, T, dev) -> tuple:
    """One compiled run: (W, H, stats, seconds, launch counts); on the card
    each of the arm's kernels must have launched."""
    launches.reset_launch_counts()
    t0 = time.perf_counter()
    W, H, stats = get_train_fn(cfg.solver, backend)(
        R, W0.copy(), H0.copy(), T, cfg, device=dev)
    secs = time.perf_counter() - t0
    counts = {name: n for name, n in launches.launch_counts().items() if n}
    if dev.type == "cuda":
        missing = [name for name in WANT_KERNELS[arm] if not counts.get(name)]
        if missing:
            raise AssertionError(f"{arm}: {missing} never launched")
    return W, H, stats, secs, counts


def _write(out_dir, arm, lines, summary) -> None:
    with open(os.path.join(out_dir, f"rmse_trajectory_ml1m_{arm}.jsonl"),
              "w") as f:
        for line in lines + [summary]:
            f.write(json.dumps(line) + "\n")


def run(maxiter: int, work: str, out_dir: str, device="cuda") -> dict:
    """Every arm at ``maxiter`` outer iterations; writes its record to
    ``out_dir`` and returns {arm: {"lines", "summary", "launches"}}."""
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    R, T = fixture(work)
    print(f"fixture+convert+load: {time.perf_counter() - t0:.1f}s "
          f"({R.rows}x{R.cols} nnz={R.nnz} test={T.nnz})", flush=True)
    where = card(dev)
    out = {}

    # CCD at AUTO (dense at ml1m dims) against the golden, same init
    cfg = Config(k=K, maxiter=maxiter, lambda_=LAM)
    bk = cfg.resolve_backend(R.rows, R.cols)
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    Wc, Hc, sc, t_c, cnt = _train("ccd", cfg, bk, R, W0, H0, T, dev)
    t0 = time.perf_counter()
    Wg, Hg = W0.copy(), H0.copy()
    sg = ccd_reference(R, Wg, Hg, T, lambda_=LAM, maxiter=maxiter)
    t_g = time.perf_counter() - t0
    # atol absorbs near-zero entries where the pure relative bar flags
    # sub-1e-4 rounding between equivalent schedules
    gw = golden_compare(Wc, Wg, atol=1e-3)
    gh = golden_compare(Hc, Hg, atol=1e-3)
    out["ccd"] = {"lines": _lines(sc, sg), "launches": cnt,
                  "golden": {"W": gw, "H": gh}, "summary": {
        "summary": True, "solver": "ccd", "backend": bk.value,
        "device": where, "k": K, "lambda": LAM, "maxiter": maxiter,
        "dataset": DATASET, "golden_W": gw.message(),
        "golden_H": gh.message(), "compiled_train_s": round(t_c, 2),
        "golden_train_s": round(t_g, 2)}}
    print(f"CCD done: golden W {gw.message()} H {gh.message()} final rmse "
          f"{sc[-1].rmse:.4f} vs {sg[-1].rmse:.4f}; launches {cnt}",
          flush=True)

    for tag, rdt, mdt, kern in HYBRIDS:
        arm = f"hybrid_{tag}"
        cfg_h = Config(k=K, maxiter=maxiter, lambda_=LAM, backend="hybrid",
                       residual_dtype=rdt, mask_dtype=mdt,
                       hybrid_panel_kernel=kern,
                       hybrid_dense_cells=2000 * R.cols)
        Wh, Hh, sh, t_h, cnt = _train(arm, cfg_h, cfg_h.backend, R, W0, H0,
                                      T, dev)
        gwh = golden_compare(Wh, Wg, atol=1e-3)
        ghh = golden_compare(Hh, Hg, atol=1e-3)
        out[arm] = {"lines": _lines(sh, sg), "launches": cnt,
                    "golden": {"W": gwh, "H": ghh}, "summary": {
            "summary": True, "solver": "ccd",
            "backend": (f"hybrid {rdt} residual + {mdt} mask"
                        + (" + panel kernels" if kern else "")),
            "device": where, "k": K, "lambda": LAM, "maxiter": maxiter,
            "dataset": DATASET, "golden_W": gwh.message(),
            "golden_H": ghh.message(),
            "max_abs_rmse_gap": round(max(
                abs(a.rmse - b.rmse) for a, b in zip(sh, sg)), 6),
            "compiled_train_s": round(t_h, 2)}}
        print(f"hybrid-{tag} done: golden W {gwh.message()} H "
              f"{ghh.message()} final rmse {sh[-1].rmse:.4f} vs "
              f"{sg[-1].rmse:.4f}; launches {cnt}", flush=True)

    # ALS at AUTO (ELL) against the golden
    cfg_a = Config(solver="als", k=K, maxiter=maxiter, lambda_=LAM)
    bk_a = cfg_a.resolve_backend(R.rows, R.cols)
    Wa0, Ha0 = init_factors_np(K, R.rows, R.cols, seed=0, entity_major=True)
    Wca, Hca, sca, t_ca, cnt = _train("als", cfg_a, bk_a, R, Wa0, Ha0, T,
                                      dev)
    t0 = time.perf_counter()
    Wga, Hga = Wa0.copy(), Ha0.copy()
    sga = als_reference(R, Wga, Hga, T, lambda_=LAM, maxiter=maxiter)
    t_ga = time.perf_counter() - t0
    gwa = golden_compare(Wca, Wga, atol=1e-3)
    gha = golden_compare(Hca, Hga, atol=1e-3)
    out["als"] = {"lines": _lines(sca, sga), "launches": cnt,
                  "golden": {"W": gwa, "H": gha}, "summary": {
        "summary": True, "solver": "als", "backend": bk_a.value,
        "device": where, "k": K, "lambda": LAM, "maxiter": maxiter,
        "dataset": DATASET, "golden_W": gwa.message(),
        "golden_H": gha.message(), "compiled_train_s": round(t_ca, 2),
        "golden_train_s": round(t_ga, 2)}}
    print(f"ALS done: golden W {gwa.message()} H {gha.message()} final rmse "
          f"{sca[-1].rmse:.4f} vs {sga[-1].rmse:.4f}; launches {cnt}",
          flush=True)

    for arm, rec in out.items():
        _write(out_dir, arm, rec["lines"], rec["summary"])
    return out


def jax_records(path: str = JAX_RECORDS) -> dict:
    """{arm: the per-iteration lines} of the JAX package's records."""
    recs = {}
    for arm in BARS:
        name = f"rmse_trajectory_ml1m_{arm}.jsonl"
        with open(os.path.join(path, name)) as f:
            recs[arm] = [line for line in map(json.loads, f)
                         if "oiter" in line]
    return recs


def golden_misses(arm: str, rec: dict) -> list:
    """An arm's misses of its own golden run: dense CCD++ must pass
    golden_compare on W and H, ALS have under ALS_GOLDEN_PCT of each off,
    a bf16 hybrid's RMSE stay within HYBRID_GOLDEN_GAP of the golden's
    (the fp8 hybrid's is reported only: an fp8 residual's rounding keeps
    it 0.078 off at 15 iterations in the JAX record)."""
    misses = []
    if arm == "ccd":
        misses += [f"ccd: golden_{side} {res.message()}"
                   for side, res in rec["golden"].items() if not res.passed]
    elif arm == "als":
        misses += [f"als: golden_{side} {res.error_percentage:.4f}% off "
                   f"(bar {ALS_GOLDEN_PCT}%)"
                   for side, res in rec["golden"].items()
                   if res.error_percentage >= ALS_GOLDEN_PCT]
    elif arm != "hybrid_fp8":
        for line in rec["lines"]:
            gap = round(abs(line["rmse_compiled"] - line["rmse_golden"]), 9)
            if gap > HYBRID_GOLDEN_GAP:
                misses.append(f"{arm} iteration {line['oiter']}: |compiled "
                              f"- golden| {gap} (bar {HYBRID_GOLDEN_GAP})")
    return misses


def compare(out: dict, jax: dict) -> list:
    """Each arm's lines against the JAX record's, iteration by iteration,
    and against its own golden run: prints the pairs and returns the
    misses of ``BARS`` and of ``golden_misses``. The records hold six
    decimals, so a difference is read to the ninth."""
    misses = []
    print("arm oiter  compiled: port jax |diff|  golden: port jax |diff|",
          flush=True)
    for arm, (bar_c, bar_g) in BARS.items():
        if arm not in out:
            misses.append(f"{arm}: no run")
            continue
        misses += golden_misses(arm, out[arm])
        ref = jax[arm]
        if len(ref) < len(out[arm]["lines"]):
            misses.append(f"{arm}: the JAX record has {len(ref)} lines")
            continue
        for got, want in zip(out[arm]["lines"], ref):
            dc = round(abs(got["rmse_compiled"] - want["rmse_compiled"]), 9)
            dg = round(abs(got["rmse_golden"] - want["rmse_golden"]), 9)
            print(f"{arm} {got['oiter']:2d}  {got['rmse_compiled']:.6f} "
                  f"{want['rmse_compiled']:.6f} {dc:.6f}  "
                  f"{got['rmse_golden']:.6f} {want['rmse_golden']:.6f} "
                  f"{dg:.6f}", flush=True)
            if dc > bar_c or dg > bar_g:
                misses.append(f"{arm} iteration {got['oiter']}: compiled "
                              f"|diff| {dc} (bar {bar_c}), golden |diff| "
                              f"{dg} (bar {bar_g})")
    return misses


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.run_trajectories",
        description="ml1m RMSE trajectories against the golden solvers and "
                    "the JAX package's records")
    p.add_argument("maxiter", nargs="?", type=int, default=15)
    p.add_argument("workdir", nargs="?", default=None,
                   help="where the fixture is converted (default: a temp "
                        "dir)")
    p.add_argument("outdir", nargs="?", default=OUT_DIR,
                   help="where the records go")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("run_trajectories: no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 2
    if args.workdir:
        out = run(args.maxiter, args.workdir, args.outdir, args.device)
    else:
        with tempfile.TemporaryDirectory() as work:
            out = run(args.maxiter, work, args.outdir, args.device)
    misses = compare(out, jax_records())
    for miss in misses:
        print(f"MISS {miss}", flush=True)
    return 1 if misses else 0


if __name__ == "__main__":
    sys.exit(main())
