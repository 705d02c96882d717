"""Training driver: backend selection, dual-run golden validation, telemetry.

The port of ``cuda_recommender_tpu/core/trainer.py``, the orchestration
counterpart of the reference's main() (reference src/main.cpp:38-173):
initialize identically-seeded factor copies, run the compiled backend (the
reference's CUDA role) on ``device`` and optionally the NumPy golden backend
(the OMP role), compute an independent final RMSE per backend
(calculate_rmse_directly, src/extras.cpp:182-216), then cross-validate with
golden_compare (src/main.cpp:133-144).

The port runs CCD++ on the ``dense``, ``pallas`` and ``hybrid`` backends
(so AUTO's every CCD++ choice but pure ELL), ALS on the ``ell`` backend
(ALS's one compiled path: any backend request but ``ref`` resolves to it),
and both on the ``ref`` backend; everything else raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import (GoldenResult, calrmse_np, golden_compare,
                            strict_misses)
from .config import Backend, Config, Solver
from .device import resolve_device
from .init import init_factors_np
from .metrics_log import MetricsLog

#: ROADMAP.md queue-1 items that port the backends outside the slice
_BACKEND_ITEMS = {Backend.ELL: "item 12: pure ELL"}
#: the compiled-backend tests' golden atol (tests/test_compiled_solvers.py:
#: 38-40): reported beside the reference's strict check when that fails, to
#: tell rounding-level misses on near-zero entries from real ones
GOLDEN_ATOL = 1e-3
#: the compiled CCD++ backends of the port
_CCD_BACKENDS = (Backend.DENSE, Backend.PALLAS, Backend.HYBRID)


@dataclasses.dataclass
class TrainResult:
    W: np.ndarray
    H: np.ndarray
    stats: list
    entity_major: bool
    backend: str
    final_rmse: float
    train_time: float
    ref_stats: Optional[list] = None
    ref_final_rmse: Optional[float] = None
    golden_W: Optional[GoldenResult] = None
    golden_H: Optional[GoldenResult] = None
    validate_time: float = 0.0


def check_supported(cfg: Config, backend: Backend, mesh=None,
                    resume_from_checkpoint: bool = False) -> None:
    """Raise NotImplementedError for a configuration outside the port,
    naming the ROADMAP.md item that ports it."""
    als = cfg.solver == Solver.ALS
    if als and cfg.phase_timing:
        raise NotImplementedError(
            "phase_timing is a CCD telemetry mode (the reference splits CCD "
            "iterations into rank/update phases, src/CCD.cpp:76-139; its ALS "
            "prints one per-iteration time, which the normal loop already "
            "measures)")
    if backend not in ((Backend.ELL, Backend.REF) if als
                       else (*_CCD_BACKENDS, Backend.REF)):
        raise NotImplementedError(
            f"backend {backend.value!r} is not in the port yet (ROADMAP.md "
            f"queue 1 {_BACKEND_ITEMS[backend]}); use 'dense', 'pallas', "
            "'hybrid' or 'ref'")
    if mesh is not None:
        raise NotImplementedError("a device mesh is not in the port yet "
                                  "(ROADMAP.md queue 1 item 15: "
                                  "multi-device)")
    if cfg.checkpoint_dir or resume_from_checkpoint:
        raise NotImplementedError("checkpoints are not in the port yet "
                                  "(ROADMAP.md queue 1 item 7: "
                                  "checkpoint/resume)")
    if backend == Backend.HYBRID:
        from ..solvers.ccd_hybrid import check_supported
        check_supported(cfg)
    if backend == Backend.DENSE:
        from ..solvers.ccd_dense import check_supported
        check_supported(cfg)
    if backend == Backend.PALLAS:
        from ..solvers.ccd_pallas import check_supported
        check_supported(cfg)
    if als and backend == Backend.ELL:
        from ..solvers.als_ell import check_supported
        check_supported(cfg)


def _run_reference(cfg: Config, R, W0, H0, T, log):
    from ..solvers.reference import als_reference, ccd_reference

    acc = {"rank": 0.0, "upd": 0.0}

    def cb(st):
        acc["rank"] += st.rank_time
        acc["upd"] += st.update_time
        log.iteration(cfg.solver.value, "ref", st.oiter, st.rmse,
                      st.rank_time, acc["rank"], st.update_time, acc["upd"],
                      rmse_time=getattr(st, "rmse_time", None))

    W, H = W0.copy(), H0.copy()
    eps = cfg.eps if cfg.early_stop else 0.0
    if cfg.solver == Solver.ALS:
        stats = als_reference(R, W, H, T, lambda_=cfg.lambda_,
                              maxiter=cfg.maxiter, callback=cb,
                              early_stop_eps=eps)
    else:
        stats = ccd_reference(R, W, H, T, lambda_=cfg.lambda_,
                              maxiter=cfg.maxiter, nmf=cfg.do_nmf,
                              maxinneriter=cfg.maxinneriter, callback=cb,
                              early_stop_eps=eps)
    return W, H, stats


def _run_compiled(cfg: Config, backend: Backend, R, W0, H0, T, log, device,
                  run: dict):
    if backend == Backend.REF:
        return _run_reference(cfg, R, W0, H0, T, log)

    acc = {"rank": 0.0, "upd": 0.0}

    def cb(st):
        if cfg.solver == Solver.ALS:
            # ALS emits one wall time per iteration; the reference prints it
            # under the update_time label (src/ALS.cpp:224-229).
            acc["upd"] += st.rank_time
            log.iteration(cfg.solver.value, backend.value, st.oiter, st.rmse,
                          0.0, 0.0, st.rank_time, acc["upd"],
                          rmse_time=getattr(st, "rmse_time", None))
            return
        acc["rank"] += st.rank_time
        acc["upd"] += st.update_time
        log.iteration(cfg.solver.value, backend.value, st.oiter, st.rmse,
                      st.rank_time, acc["rank"], st.update_time, acc["upd"],
                      rmse_time=getattr(st, "rmse_time", None))

    return solve(cfg, backend, R, W0, H0, T, device=device, callback=cb,
                 log=log, run=run)


def solve(cfg: Config, backend: Backend, R, W0, H0, T, *, device,
          callback=None, log: Optional[MetricsLog] = None,
          run: Optional[dict] = None):
    """Run the compiled solver of (``cfg.solver``, ``backend``) — the path
    ``train()`` runs — on ``device``; returns (W, H, stats). Prints nothing
    unless ``log`` is given. The hybrid backend writes its orientation and
    plan into ``run`` (``ccd_hybrid_train``); the others leave it as it
    is."""
    if cfg.solver == Solver.ALS:
        from ..solvers.als_ell import als_ell_train
        return als_ell_train(R, W0, H0, T, cfg, device=device,
                             callback=callback, log=log)
    if backend == Backend.PALLAS:
        from ..solvers.ccd_pallas import ccd_pallas_train
        return ccd_pallas_train(R, W0, H0, T, cfg, device=device,
                                callback=callback, log=log)
    if backend == Backend.DENSE:
        from ..solvers.ccd_dense import ccd_dense_train
        return ccd_dense_train(R, W0, H0, T, cfg, device=device,
                               callback=callback, log=log)
    from ..solvers.ccd_hybrid import ccd_hybrid_train
    return ccd_hybrid_train(R, W0, H0, T, cfg, device=device,
                            callback=callback, log=log, run=run)


def train(cfg: Config, R: RatingMatrix, T: TestCOO, *, device="cuda",
          mesh=None, log: Optional[MetricsLog] = None,
          resume_from_checkpoint: bool = False) -> TrainResult:
    """Full training run on ``device`` ("cuda" or "cpu"; "cuda" without a
    GPU raises) with optional golden validation (cfg.golden)."""
    backend = cfg.resolve_backend(R.rows, R.cols)
    check_supported(cfg, backend, mesh, resume_from_checkpoint)
    device = resolve_device(device)
    log = log or MetricsLog(cfg.metrics_file)
    entity_major = cfg.solver == Solver.ALS
    log.info(f"[info] Picked Version: {cfg.solver.value.upper()}!")
    log.info("[info] Backend = %s | K = %d | InnerIter = %d | OuterIter = %d "
             "| L = %.3f" % (backend.value, cfg.k, cfg.maxinneriter,
                             cfg.maxiter, cfg.lambda_))

    # identical init for every backend copy — the reference's srand(0)
    # discipline that makes golden_compare meaningful (src/main.cpp:86-98)
    W0, H0 = init_factors_np(cfg.k, R.rows, R.cols, seed=cfg.seed,
                             entity_major=entity_major)

    log.info(f"[INFO] Computing with {backend.value} backend...")
    t0 = time.perf_counter()
    run: dict = {}
    W, H, stats = _run_compiled(cfg, backend, R, W0.copy(), H0.copy(), T, log,
                                device, run)
    train_time = time.perf_counter() - t0
    log.info("[info] %s Training time: %f s." % (backend.value, train_time))
    t0 = time.perf_counter()
    final_rmse = calrmse_np(T, W, H, entity_major=entity_major)
    log.info("Test RMSE = %f. Calculated in %fs"
             % (final_rmse, time.perf_counter() - t0))

    result = TrainResult(W=W, H=H, stats=stats, entity_major=entity_major,
                         backend=backend.value, final_rmse=final_rmse,
                         train_time=train_time)

    if cfg.golden:
        log.info("[INFO] Computing with reference (golden) backend...")
        t0 = time.perf_counter()
        if run.get("transposed"):
            # the transposed stair solved Rᵀ with the item side seeded: the
            # golden run is the reference on the SAME transposed problem
            from ..solvers.ccd_hybrid import transpose_test
            Wt, Ht, ref_stats = _run_reference(cfg, R.transpose(), H0, W0,
                                               transpose_test(T), log)
            W_ref, H_ref = Ht, Wt
        else:
            W_ref, H_ref, ref_stats = _run_reference(cfg, R, W0, H0, T, log)
        log.info("[info] ref Training time: %f s." % (time.perf_counter() - t0))
        result.ref_stats = ref_stats
        result.ref_final_rmse = calrmse_np(T, W_ref, H_ref,
                                           entity_major=entity_major)
        log.info("Test RMSE = %f." % result.ref_final_rmse)
        log.info("[info] validate the results.")
        t0 = time.perf_counter()
        result.golden_W = golden_compare(W, W_ref)
        result.golden_H = golden_compare(H, H_ref)
        near = [golden_compare(A, B, atol=GOLDEN_ATOL).passed
                for A, B in ((W, W_ref), (H, H_ref))]
        misses = [strict_misses(A, B) for A, B in ((W, W_ref), (H, H_ref))]
        result.validate_time = time.perf_counter() - t0
        log.info(result.golden_W.message())
        log.info(result.golden_H.message())
        if not (result.golden_W.passed and result.golden_H.passed):
            log.info("[info] golden with atol %g: W %s, H %s"
                     % (GOLDEN_ATOL, *("PASS" if p else "NO PASS"
                                       for p in near)))
            log.info("[info] golden misses: W max|ref| %.3e max|diff| %.3e, "
                     "H max|ref| %.3e max|diff| %.3e"
                     % (*misses[0], *misses[1]))
        log.info("[info] Validate Time: %f s." % result.validate_time)
        log.event("golden", W_pass=result.golden_W.passed,
                  H_pass=result.golden_H.passed, W_pass_atol=near[0],
                  H_pass_atol=near[1],
                  W_err_pct=result.golden_W.error_percentage,
                  H_err_pct=result.golden_H.error_percentage,
                  W_miss_ref=misses[0][0], W_miss_diff=misses[0][1],
                  H_miss_ref=misses[1][0], H_miss_diff=misses[1][1])
    return result
