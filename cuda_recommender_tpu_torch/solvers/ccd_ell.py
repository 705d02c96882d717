"""CCD++ — padded-ELL backend (the general sparse path), in PyTorch.

The port of ``cuda_recommender_tpu/solvers/ccd_ell.py`` for one GPU, the
counterpart of the reference's CUDA CCD++ kernels (reference
cuda_src/CCD_CUDA.cu:3-104) for matrices with no dense panel at all: AUTO
picks it when not even one panel row fits the hybrid's cell budget
(core/config.py::resolve_backend), and ``backend="ell"`` asks for it.
Ratings live in the degree-bucketed padded-ELL layout (data/ell.py) in BOTH
orientations, mirroring the reference's dual R/Rt residual storage
(cuda_src/CCD_CUDA.cu:300-316); factors live in slot space for the whole
run (solvers/ell_state.py), so the rank loop has no scatter.

It is the hybrid backend's ELL tail without panels, and it runs the same
plain torch gathers and reductions (ops/ell_ops.py; the JAX package leaves
this path to XLA, so no Pallas kernel is on it: its hand kernel is
ROADMAP.md queue 2 item 2). Per rank and side ONE gather pass: the subtract
of rank t-1's new outer product is deferred and carried as ``(u_pend,
v_pend)``, folded with the add-back of rank t into the pass that also
yields the sweep partials (``fused_update_sweep``); the add-back runs
unconditionally (H[t] is 0 in outer iteration 1, so it vanishes there).
``make_ell_phase_fns`` is the reference's plain order (add-back, sweeps,
immediate subtract) for phase timing (solvers/phase_loop.py).

Semantics preserved (SURVEY.md §7): H zeroed at entry (src/CCD.cpp:56-60);
λ·nnz regularization (src/CCD.cpp:112,120); v-sweep before u-sweep each
inner iteration (src/CCD.cpp:110-121); empty entity -> 0 factor;
rank-major factor layout. New factors come from ccd_dense's
``_half_sweep``, which guards on λ·nnz + h > 0 where the JAX package's ELL
backend guards on nnz > 0: the two agree wherever JAX's value is finite
(they part only at λ = 0 with h = 0, where JAX divides 0 by 0).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device, synchronize
from ..core.metrics_log import MetricsLog
from ..data.ell import EllPair, EllSide, build_ell_pair
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.ell_ops import (extend_zero, fused_sweep, fused_update_sweep,
                           residual_update, sweep_partials)
from .ccd_dense import _half_sweep
from .ell_state import (EllState, ell_state_from_numpy, ell_state_to_numpy,
                        factors_to_slots)
from .phase_loop import phased_ccd_loop, rank_rows, refuse_pending
from .pipeline import pipelined_loop
from .reference import IterStats


def side_tiles(side: EllSide, device) -> tuple:
    """A side's bucket index tiles on ``device``, int64."""
    return tuple(torch.as_tensor(b.idx.astype(np.int64), device=device)
                 for b in side.buckets)


def initial_state(ell: EllPair, W0: np.ndarray, device) -> EllState:
    """Training state at outer iteration 1: the value tiles hold the
    ratings, W is ``W0`` in slot space, H is zero (src/CCD.cpp:56-60) and
    nothing is pending."""
    rows, cols = ell.rows_side, ell.cols_side
    zeros = dict(dtype=torch.float32, device=device)
    return EllState(
        vals_r=[torch.as_tensor(b.val, device=device).clone()
                for b in rows.buckets],
        vals_c=[torch.as_tensor(b.val, device=device).clone()
                for b in cols.buckets],
        W=torch.as_tensor(factors_to_slots(np.asarray(W0, np.float32), rows),
                          device=device),
        H=torch.zeros((W0.shape[0], cols.n_slots), **zeros),
        u_pend=torch.zeros(rows.n_slots, **zeros),
        v_pend=torch.zeros(cols.n_slots, **zeros))


def make_ell_outer_step(ell: EllPair, idx_r, idx_c, rnnz_r, rnnz_c,
                        lam: float, maxinneriter: int, *, nmf: bool = False,
                        gather: Optional[Callable] = None,
                        ) -> Callable[[EllState], torch.Tensor]:
    """One outer iteration over all k ranks (a Python loop), updating the
    state IN PLACE (the JAX step donates it). Returns the state's W.

    ``gather`` (the sharded step, parallel/ccd_ell_sharded.py) turns the
    stacked slot vectors of this rank's slot block into the global table
    the gathers read (an all-gather); ``ell`` is then the rank's shard of
    the layout. Without it the slot vectors are the table."""
    rows, cols = ell.rows_side, ell.cols_side

    def table(*vecs) -> torch.Tensor:
        t = torch.stack(vecs, -1)
        return extend_zero(t if gather is None else gather(t))

    def rank(st: EllState, t: int) -> None:
        u_old, v_old = st.W[t], st.H[t]
        u, v = u_old, v_old
        for i in range(maxinneriter):
            # ---- v-sweep (cols side): the deferred subtract of rank t-1,
            # the add-back of rank t and the sweep in ONE gather pass of
            # the stacked [u_pend, u_old] table ----
            if i == 0:
                g, h = fused_update_sweep(
                    idx_c, st.vals_c, cols, table(st.u_pend, u_old),
                    owns=(st.v_pend, v_old), signs=(-1.0, 1.0), sweep_col=1)
            else:
                g, h = fused_sweep(idx_c, st.vals_c, cols, table(u, u))
            v = _half_sweep(g, h, lam, rnnz_c, nmf)
            # ---- u-sweep (rows side): [v_pend, v_old, v_new] — deferred
            # subtract, add-back and the sweep with the NEW v ----
            if i == 0:
                gu, hu = fused_update_sweep(
                    idx_r, st.vals_r, rows, table(st.v_pend, v_old, v),
                    owns=(st.u_pend, u_old), signs=(-1.0, 1.0), sweep_col=2)
            else:
                gu, hu = fused_sweep(idx_r, st.vals_r, rows, table(v, v))
            u = _half_sweep(gu, hu, lam, rnnz_r, nmf)
        # ---- write back (src/CCD.cpp:128-134); the subtract of rank t's
        # new outer product is deferred to rank t+1 ----
        st.W[t] = u
        st.H[t] = v
        st.u_pend, st.v_pend = u, v

    def step(st: EllState) -> torch.Tensor:
        for t in range(st.W.shape[0]):
            rank(st, t)
        return st.W

    return step


def make_ell_phase_fns(ell: EllPair, idx_r, idx_c, rnnz_r, rnnz_c,
                       lam: float, maxinneriter: int, *, nmf: bool = False):
    """Phase-split step functions for phase timing (solvers/phase_loop.py):
    the reference's plain schedule (add-back, sweeps, immediate subtract,
    src/CCD.cpp:74-139) as three separately fenced passes — the same math
    as ``make_ell_outer_step``, without the pending state. Each is
    ``fn(state, t)`` and updates the state in place."""
    rows, cols = ell.rows_side, ell.cols_side

    def _both_sides(st: EllState, t: int, sign: float) -> None:
        u, v = st.W[t], st.H[t]
        residual_update(idx_c, st.vals_c, cols, extend_zero(u), v, sign)
        residual_update(idx_r, st.vals_r, rows, extend_zero(v), u, sign)

    def addback(st: EllState, t: int) -> None:
        _both_sides(st, t, 1.0)

    def subtract(st: EllState, t: int) -> None:
        _both_sides(st, t, -1.0)

    def sweeps(st: EllState, t: int) -> None:
        u, v = st.W[t], st.H[t]
        for _ in range(maxinneriter):          # src/CCD.cpp:107-123
            v = _half_sweep(*sweep_partials(idx_c, st.vals_c, cols,
                                            extend_zero(u)),
                            lam, rnnz_c, nmf)
            u = _half_sweep(*sweep_partials(idx_r, st.vals_r, rows,
                                            extend_zero(v)),
                            lam, rnnz_r, nmf)
        st.W[t] = u
        st.H[t] = v

    return addback, sweeps, subtract


def ccd_ell_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                  T: TestCOO, cfg: Config, *, device="cuda",
                  callback: Optional[Callable[[IterStats], None]] = None,
                  log: Optional[MetricsLog] = None,
                  ckpt_every: int = 0, ckpt_fn=None, resume=None,
                  rank_callback=None,
                  ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train CCD++ on the ELL backend on ``device``. Returns (W, H, stats)
    in the reference's rank-major entity order. ``H0`` is accepted for the
    solvers' common signature; CCD++ zeroes H at entry (src/CCD.cpp:56-60).
    Checkpoint payloads (``ckpt_fn(oiter, payload)`` every ``ckpt_every``
    outer iterations) carry the slot-space factors, the pending outer
    product and both residual value sets (solvers/ell_state.py);
    ``resume`` (such a payload plus its ``oiter``) continues a run. With
    ``cfg.phase_timing`` the phases are fenced and timed apart
    (``rank_callback(oiter, t, dt, rmse)`` per rank). With ``log``, the
    layout and the set-up times are reported as an info line and an
    ``ell_plan`` event."""
    dev = resolve_device(device)
    if cfg.phase_timing:
        refuse_pending(resume)
    t0 = time.perf_counter()
    ell = build_ell_pair(R, min_width=cfg.ell_min_width, num_shards=1)
    rows, cols = ell.rows_side, ell.cols_side
    t1 = time.perf_counter()
    idx_r, idx_c = side_tiles(rows, dev), side_tiles(cols, dev)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        state = ell_state_from_numpy(resume, ell, dev)
    else:
        state = initial_state(ell, W0, dev)
    rnnz_r = torch.as_tensor(rows.slot_nnz, device=dev)
    rnnz_c = torch.as_tensor(cols.slot_nnz, device=dev)
    synchronize(dev)
    t2 = time.perf_counter()
    if log is not None:
        sides = {name: dict(widths=[b.E for b in side.buckets],
                            n_slots=side.n_slots,
                            padded_lanes=side.nnz_padded)
                 for name, side in (("rows", rows), ("cols", cols))}
        log.info("[info] ell plan: " + "; ".join(
            f"{name} side {len(s['widths'])} buckets (widths "
            f"{s['widths']}), {s['padded_lanes']} padded lanes"
            for name, s in sides.items())
            + f"; plan {t1 - t0:.3f} s, device set-up {t2 - t1:.3f} s")
        log.event("ell_plan", nnz=R.nnz, sides=sides, plan_s=t1 - t0,
                  setup_s=t2 - t1)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti_np = rows.slot_of_entity[T.row_idx]
    tj_np = cols.slot_of_entity[T.col_idx]
    ti, tj = i64(ti_np), i64(tj_np)
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)
    eps = cfg.eps if cfg.early_stop else 0.0
    common = dict(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        do_rmse=lambda: calrmse_device(ti, tj, tv, state.W, state.H,
                                       entity_major=False, chunk=chunk),
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=lambda: ell_state_to_numpy(state), early_stop_eps=eps)
    lam, inner, nmf = cfg.lambda_, cfg.maxinneriter, cfg.do_nmf

    if cfg.phase_timing:
        ab, sw, sub = make_ell_phase_fns(ell, idx_r, idx_c, rnnz_r, rnnz_c,
                                         lam, inner, nmf=nmf)
        stats = phased_ccd_loop(
            k=W0.shape[0], device=dev,
            addback=lambda t: ab(state, t), sweeps=lambda t: sw(state, t),
            subtract=lambda t: sub(state, t),
            get_rank_rows=rank_rows(state),
            ti=ti_np, tj=tj_np, tv=np.asarray(T.val),
            rank_callback=rank_callback, **common)
    else:
        step = make_ell_outer_step(ell, idx_r, idx_c, rnnz_r, rnnz_c, lam,
                                   inner, nmf=nmf)
        stats = pipelined_loop(fuse=cfg.fused_outer_iters,
                               do_step=lambda: step(state), **common)

    W = state.W.cpu().numpy()[:, rows.slot_of_entity]
    H = state.H.cpu().numpy()[:, cols.slot_of_entity]
    return W, H, stats
