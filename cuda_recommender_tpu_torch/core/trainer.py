"""Training driver: backend selection, dual-run golden validation, telemetry.

The port of ``cuda_recommender_tpu/core/trainer.py``, the orchestration
counterpart of the reference's main() (reference src/main.cpp:38-173):
initialize identically-seeded factor copies, run the compiled backend (the
reference's CUDA role) on ``device`` and optionally the NumPy golden backend
(the OMP role), compute an independent final RMSE per backend
(calculate_rmse_directly, src/extras.cpp:182-216), then cross-validate with
golden_compare (src/main.cpp:133-144).

The port runs CCD++ on the ``dense``, ``pallas``, ``hybrid`` and ``ell``
backends (so every AUTO choice), ALS on the ``ell`` backend (ALS's one
compiled path: any backend request but ``ref`` resolves to it), and both on
the ``ref`` backend, each with checkpoint/resume (``cfg.checkpoint_dir``,
``resume_from_checkpoint``; core/checkpoint.py) and CCD++ with phase timing
on dense, hybrid and ell (solvers/phase_loop.py). With a ``mesh``
(parallel/mesh.py: one rank a process, ``torch.distributed``) the sharded
trainers of parallel/ run ALS, ell, hybrid and dense (1-D or 2-D); every
rank returns the same factors, and only rank 0 prints, writes the metrics
file and checkpoints, and runs the golden check. Every knob of the JAX
package's ``Config`` runs, the fp8 residual and ``hybrid_defer_group``
included; what raises is the JAX package's own refusals.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np

from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import (GoldenResult, calrmse_np, golden_compare,
                            strict_misses)
from .checkpoint import Checkpointer
from .config import Backend, Config, Solver
from .device import resolve_device
from .init import init_factors_np
from .metrics_log import MetricsLog

#: the compiled-backend tests' golden atol (tests/test_compiled_solvers.py:
#: 38-40): reported beside the reference's strict check when that fails, to
#: tell rounding-level misses on near-zero entries from real ones
GOLDEN_ATOL = 1e-3


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
    ref_W: Optional[np.ndarray] = None      # the golden run's factors
    ref_H: Optional[np.ndarray] = None
    golden_W: Optional[GoldenResult] = None
    golden_H: Optional[GoldenResult] = None
    validate_time: float = 0.0


def check_supported(cfg: Config, backend: Backend, mesh=None) -> None:
    """Raise for a configuration the JAX package refuses too: phase timing
    on pallas, ALS or a mesh; the pallas backend or the transposed stair
    with a mesh (NotImplementedError); the dense backend with the NaN
    sentinel (ValueError)."""
    als = cfg.solver == Solver.ALS
    if als and cfg.phase_timing and backend != Backend.REF:
        raise NotImplementedError(
            "phase_timing is a CCD telemetry mode (the reference splits CCD "
            "iterations into rank/update phases, src/CCD.cpp:76-139; its ALS "
            "prints one per-iteration time, which the normal loop already "
            "measures)")
    if cfg.phase_timing and mesh is not None and not als \
            and backend != Backend.REF:
        raise NotImplementedError(
            "phase_timing is single-device in the trainer loop; the "
            "sharded hybrid path has per-phase shard_map dispatches "
            "(parallel.ccd_hybrid_sharded.make_sharded_hybrid_phase_"
            "fns, exercised with measured rank/update times on a "
            "2+-device mesh by tests/test_hybrid_sharded.py)")
    if cfg.phase_timing and backend == Backend.PALLAS:
        raise NotImplementedError(
            "phase_timing is not implemented for the pallas backend; "
            "use dense (same dense-residual schedule) — hybrid, dense "
            "and ell all support it")
    if mesh is not None and not als and backend == Backend.PALLAS:
        raise NotImplementedError(
            "the Pallas backend is single-chip; use backend=dense or ell "
            "with --mesh")
    if mesh is not None and not als and backend == Backend.HYBRID \
            and cfg.hybrid_transpose:
        raise NotImplementedError(
            "hybrid_transpose is single-device-only (the sharded "
            "hybrid plans the classic user-axis stair)")
    if backend == Backend.DENSE:
        from ..solvers.ccd_dense import check_supported
        check_supported(cfg)


def checkpoint_meta(cfg: Config, backend: Backend,
                    num_shards: int = 1) -> dict:
    """Layout-determining knobs stamped into the checkpoint manifest, per
    backend, with the JAX package's keys and values (its trainer.py::
    checkpoint_meta; ``num_shards`` the mesh's ranks): ELL and hybrid
    payloads are slot- or panel-space, so resuming under a different k,
    bucket width or panel plan would map them onto a different layout — a
    shape error at best, silently wrong factors when shapes coincide. Only
    knobs the backend's payload depends on are stamped."""
    meta: dict = {
        # slot-layout algorithm version: 2 = data-driven width ladder
        # (data/ell.py _choose_widths)
        "ell_layout": 2,
        "k": cfg.k,
        "num_shards": num_shards,
    }
    if cfg.solver == Solver.ALS:
        meta["min_width"] = cfg.als_min_width
    elif backend in (Backend.ELL, Backend.HYBRID):
        meta["min_width"] = cfg.ell_min_width
    if backend == Backend.HYBRID:
        meta["hybrid_dense_cells"] = cfg.hybrid_dense_cells
        meta["hybrid_panel_widths"] = list(cfg.hybrid_panel_widths)
        # the panel kernel block-pads the panel payloads (solvers/
        # hybrid_state.py), so it is layout-bearing
        meta["hybrid_panel_kernel"] = cfg.hybrid_panel_kernel
    return meta


def load_resume(cfg: Config, backend: Backend,
                ckpt: Optional[Checkpointer],
                num_shards: int = 1) -> Optional[dict]:
    """The latest checkpoint of ``ckpt`` as a solver's ``resume`` payload
    ({"oiter", "W", "H", extras...}), or None when there is none. Raises
    ValueError, with the JAX package's texts, when there is no
    checkpoint_dir or the checkpoint was written by another solver,
    backend or layout."""
    if ckpt is None:
        raise ValueError("resume requested but no checkpoint_dir set")
    latest = ckpt.latest()
    if latest is None:
        return None
    if (latest.get("solver") and latest["solver"] != cfg.solver.value) \
            or (latest.get("backend") and latest["backend"] != backend.value):
        raise ValueError(
            f"checkpoint was written by solver={latest.get('solver')} "
            f"backend={latest.get('backend')} but this run is "
            f"solver={cfg.solver.value} backend={backend.value} — payloads "
            "are incompatible")
    want = checkpoint_meta(cfg, backend, num_shards)
    have = latest.get("meta") or {}
    bad = {key: (have[key], want[key]) for key in want
           if key in have and have[key] != want[key]}
    if bad:
        raise ValueError(
            "checkpoint layout mismatch (slot-space payloads are only "
            "valid under the writing run's layout knobs): "
            + ", ".join(f"{key}: checkpoint={a} run={b}"
                        for key, (a, b) in bad.items()))
    return {"oiter": latest["oiter"], "W": latest["W"], "H": latest["H"],
            **latest["extra"]}


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
                  run: dict, ckpt=None, resume=None, mesh=None):
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

    kw: dict = {}
    if cfg.phase_timing and cfg.verbose:
        kw["rank_callback"] = (
            lambda oiter, t, dt, rmse: log.rank(
                cfg.solver.value, backend.value, oiter, t, dt, rmse))
    if ckpt is not None:
        meta = checkpoint_meta(cfg, backend, _shards(mesh))

        def save(oiter, payload):
            if payload is not None:      # a sharded run: rank 0 writes
                t0 = time.perf_counter()
                path = ckpt.save(oiter, W=payload.pop("W"),
                                 H=payload.pop("H"), solver=cfg.solver.value,
                                 backend=backend.value, extra=payload,
                                 meta=meta)
                log.event("checkpoint", oiter=oiter,
                          bytes=os.path.getsize(path),
                          save_s=time.perf_counter() - t0)
            if mesh is not None:
                # every rank waits for rank 0's file: a rank that ran ahead
                # into a resume would otherwise read the previous
                # checkpoint and leave its peers' collectives unmatched
                import torch.distributed as dist
                dist.barrier()

        kw.update(ckpt_every=cfg.checkpoint_every, ckpt_fn=save)
    if resume is not None:
        kw["resume"] = resume
    return solve(cfg, backend, R, W0, H0, T, device=device, callback=cb,
                 log=log, run=run, mesh=mesh, **kw)


def _shards(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def _solve_sharded(cfg: Config, backend: Backend, R, W0, H0, T, mesh, *,
                   run=None, **kw):
    """The sharded trainers (parallel/), the JAX trainer's mesh dispatch
    (its core/trainer.py:106-138)."""
    if cfg.solver == Solver.ALS:
        from ..parallel.als_ell_sharded import als_ell_train_sharded
        return als_ell_train_sharded(R, W0, H0, T, cfg, mesh, **kw)
    if backend == Backend.HYBRID:
        from ..parallel.ccd_hybrid_sharded import ccd_hybrid_train_sharded
        return ccd_hybrid_train_sharded(R, W0, H0, T, cfg, mesh, run=run,
                                        **kw)
    if backend == Backend.DENSE:
        from ..parallel.mesh import dense_ccd_shardings, dense_ccd_shardings_2d
        from ..solvers.ccd_dense import ccd_dense_train
        blocks = (dense_ccd_shardings_2d(mesh) if mesh.ndim == 2
                  else dense_ccd_shardings(mesh))
        return ccd_dense_train(R, W0, H0, T, cfg, shardings=blocks, **kw)
    from ..parallel.ccd_ell_sharded import ccd_ell_train_sharded
    return ccd_ell_train_sharded(R, W0, H0, T, cfg, mesh, **kw)


def solve(cfg: Config, backend: Backend, R, W0, H0, T, *, device,
          callback=None, log: Optional[MetricsLog] = None,
          run: Optional[dict] = None, mesh=None, **kw):
    """Run the compiled solver of (``cfg.solver``, ``backend``) — the path
    ``train()`` runs — on ``device``; returns (W, H, stats). Prints nothing
    unless ``log`` is given. The hybrid backend writes its orientation and
    plan into ``run`` (``ccd_hybrid_train``); the others leave it as it
    is. ``kw``: the solvers' checkpoint and phase-timing hooks
    (``ckpt_every``, ``ckpt_fn``, ``resume``, ``rank_callback``). With a
    ``mesh`` the sharded trainers run (ref ignores it)."""
    if mesh is not None and backend != Backend.REF:
        return _solve_sharded(cfg, backend, R, W0, H0, T, mesh,
                              device=device, callback=callback, log=log,
                              run=run, **kw)
    if cfg.solver == Solver.ALS:
        from ..solvers.als_ell import als_ell_train
        return als_ell_train(R, W0, H0, T, cfg, device=device,
                             callback=callback, log=log, **kw)
    if backend == Backend.PALLAS:
        from ..solvers.ccd_pallas import ccd_pallas_train
        return ccd_pallas_train(R, W0, H0, T, cfg, device=device,
                                callback=callback, log=log, **kw)
    if backend == Backend.DENSE:
        from ..solvers.ccd_dense import ccd_dense_train
        return ccd_dense_train(R, W0, H0, T, cfg, device=device,
                               callback=callback, log=log, **kw)
    if backend == Backend.ELL:
        from ..solvers.ccd_ell import ccd_ell_train
        return ccd_ell_train(R, W0, H0, T, cfg, device=device,
                             callback=callback, log=log, **kw)
    from ..solvers.ccd_hybrid import ccd_hybrid_train
    return ccd_hybrid_train(R, W0, H0, T, cfg, device=device,
                            callback=callback, log=log, run=run, **kw)


def train(cfg: Config, R: RatingMatrix, T: TestCOO, *, device="cuda",
          mesh=None, log: Optional[MetricsLog] = None,
          resume_from_checkpoint: bool = False) -> TrainResult:
    """Full training run on ``device`` ("cuda" or "cpu"; "cuda" without a
    GPU raises) with optional golden validation (cfg.golden) and
    checkpoint/resume (cfg.checkpoint_dir / resume_from_checkpoint).

    ``mesh`` (parallel/mesh.py, over the initialized process group): every
    rank calls ``train`` with the same data and gets the same factors; the
    rank trains on ``cuda:{LOCAL_RANK}`` for ``device="cuda"``. Rank 0
    alone logs (``log`` and ``cfg.metrics_file``), writes checkpoints and
    runs the golden check; every rank reads a resumed checkpoint, so
    ``checkpoint_dir`` must be visible to all of them."""
    backend = cfg.resolve_backend(R.rows, R.cols)
    check_supported(cfg, backend, mesh)
    device = resolve_device(device)
    root = True
    if mesh is not None:
        from ..parallel.multihost import rank_device
        device = rank_device(device)
        root = mesh.get_rank() == 0
    if not root:
        log = MetricsLog(None, echo=False)
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

    ckpt = Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    resume = None
    if resume_from_checkpoint:
        t0 = time.perf_counter()
        resume = load_resume(cfg, backend, ckpt, _shards(mesh))
        if resume is not None:
            log.info(f"[info] resuming from checkpoint oiter="
                     f"{resume['oiter']}")
            log.event("resume", oiter=resume["oiter"],
                      load_s=time.perf_counter() - t0)

    log.info(f"[INFO] Computing with {backend.value} backend...")
    t0 = time.perf_counter()
    run: dict = {}
    W, H, stats = _run_compiled(cfg, backend, R, W0.copy(), H0.copy(), T, log,
                                device, run, ckpt=ckpt, resume=resume,
                                mesh=mesh)
    train_time = time.perf_counter() - t0
    log.info("[info] %s Training time: %f s." % (backend.value, train_time))
    t0 = time.perf_counter()
    final_rmse = calrmse_np(T, W, H, entity_major=entity_major)
    log.info("Test RMSE = %f. Calculated in %fs"
             % (final_rmse, time.perf_counter() - t0))

    result = TrainResult(W=W, H=H, stats=stats, entity_major=entity_major,
                         backend=backend.value, final_rmse=final_rmse,
                         train_time=train_time)

    if cfg.golden and root:
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
        result.ref_W, result.ref_H = W_ref, H_ref
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
