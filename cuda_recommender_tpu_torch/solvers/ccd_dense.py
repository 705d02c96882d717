"""CCD++ — dense-residual backend, in PyTorch.

The port of ``cuda_recommender_tpu/solvers/ccd_dense.py`` for one GPU. The
residual is a dense (m, n) array kept only at observed cells (zero
elsewhere) beside a {0,1} mask of bfloat16 or int8 (both exact), so every
sweep is a streaming pass over the residual (the reference's CSC walk,
reference cuda_src/CCD_CUDA.cu:224-451, re-derived as matvec pairs).

Schedule (the JAX package's deferred-subtract form): per rank t ONE
read-modify-write pass applies the subtract of rank t-1's new outer product
and the add-back of rank t,

    Rhat += (outer(u_add, v_add) - outer(u_sub, v_sub)) * mask,

with (u_sub, v_sub) carried across ranks and outer iterations in the state
(``u_pend``, ``v_pend``); the add-back is unconditional (H[t] is 0 in outer
iteration 1, so it vanishes there).

On the card the step runs the JAX package's **pallas** schedule through the
hand-written kernels (ops/ccd_kernels.py): K4 ``fused_update_vsweep`` does
the update and the first v-sweep in one pass, ``masked_usweep`` the
u-sweep, ``masked_vsweep`` the v-sweeps of inner iterations i > 0. The JAX
package kept XLA's unfused step for this backend only because XLA's
cross-op fusion matched the Pallas kernel on v5e (its core/config.py:
280-284); eager PyTorch has no such fusion, and a torch-op step would
stream (m, n) f32 temporaries on every pass. At f32 the two schedules are
the same math: the dense step sweeps the stored residual, K4 the f32 sum it
stores. At bf16 they differ, and the port follows the pallas schedule, not
the JAX dense step: that step rounds delta·mask to bf16 before the add and
sweeps the stored value; K4 rounds the f32 sum once and sweeps that sum
(one bf16 ULP apart, accepted). At fp8 the two orders differ in about a
quarter of the observed cells, so there K4 stores in the order of the
backend it runs for (``order``, ops/densify.py::store_order): the JAX dense
step's "delta_first" here, the Pallas kernel's "once" for the pallas
backend (solvers/ccd_pallas.py). On the CPU the same step runs the
kernels' plain PyTorch versions.

Phase timing (``cfg.phase_timing``, solvers/phase_loop.py) runs the
reference's plain order per rank instead: add-back, sweeps, immediate
subtract, each fenced. The sweeps are ``masked_vsweep`` and
``masked_usweep``; the add-back and subtract are plain torch
(``rank1_update``), as XLA computes them in the JAX package, with its
rounding: the delta·mask is rounded to the residual's dtype, then the sum
(at fp8 too, where the sum is formed in f32: torch adds no fp8).

Semantics preserved (SURVEY.md §7): H zeroed at entry (src/CCD.cpp:56-60);
λ scaled by the entity's nnz (src/CCD.cpp:112,120); empty entity → 0
(src/CCD.cpp:8, through the full-denominator guard); v-sweep before u-sweep
per inner iteration (src/CCD.cpp:110-121); rank-major (k, n) factors.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device, synchronize
from ..core.metrics_log import MetricsLog
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.ccd_kernels import fused_update_vsweep, masked_usweep, masked_vsweep
from ..ops.densify import (FP8, RESIDUAL_DTYPES, densify_coo_mask,
                           store_order)
from ..ops.panel_kernels import rounded_f32, store
from ..parallel.collectives import (all_gather_rows, all_reduce_pair,
                                    gather_arrays)
from ..parallel.multihost import rank_device
from .dense_state import (DenseState, dense_payload_assemble,
                          dense_payload_block, dense_state_from_numpy,
                          dense_state_to_numpy)
from .phase_loop import phased_ccd_loop, rank_rows, refuse_pending
from .pipeline import pipelined_loop
from .reference import IterStats

#: cells of one row block of ``rank1_update``: its f32 delta temporary is
#: at most 1 GiB
UPDATE_BLOCK_CELLS = 1 << 28


def check_supported(cfg: Config) -> None:
    """Raise ValueError for ``mask_dtype="nan"``: the dense residual keeps
    an explicit mask (the NaN sentinel is a hybrid-panel layout; the JAX
    package fails there too)."""
    if cfg.mask_dtype == "nan":
        raise ValueError("the dense backend needs an explicit mask "
                         "(mask_dtype 'bfloat16' or 'int8'); the NaN "
                         "sentinel is a hybrid-panel layout")


def _half_sweep(g: torch.Tensor, h: torch.Tensor, lam: float,
                nnz: torch.Tensor, nmf: bool = False) -> torch.Tensor:
    """One side of a rank-one sweep from its partial sums g = Σ other·R and
    h = Σ other²·mask: new_j = g_j / (λ·nnz_j + h_j), 0 where that
    denominator is not positive (the JAX package's ``_half_sweep``,
    ccd_dense.py:69-79). ``nmf`` clamps at 0 (libpmf -N semantics). The
    hybrid and ELL backends take their new factors here too."""
    den = lam * nnz + h
    out = torch.where(den > 0, g / den, 0.0)
    return out.clamp_min(0.0) if nmf else out


def _no_reduce(g, h):
    return g, h


def make_outer_step(lam: float, maxinneriter: int, *, nmf: bool = False,
                    reduce_v: Callable = _no_reduce,
                    reduce_u: Callable = _no_reduce, order: str,
                    ) -> Callable[..., torch.Tensor]:
    """One outer iteration over all k ranks (a Python loop), updating the
    state IN PLACE (the JAX step donates it). ``step(state, mask, row_nnz,
    col_nnz)`` returns the state's W. ``order`` is K4's store order
    ("delta_first": an fp8 residual's on the JAX dense step).
    ``reduce_v(g, h)`` and ``reduce_u(g, h)`` (a sharded residual) sum the
    v-sweep's and the u-sweep's partials over the ranks that share the
    block's columns and rows before the division; the state is then this
    rank's block."""

    def step(st: DenseState, mask, row_nnz, col_nnz) -> torch.Tensor:
        def new_v(u_sweep):
            return _half_sweep(*reduce_v(*u_sweep), lam, col_nnz, nmf)

        def new_u(v):
            return _half_sweep(*reduce_u(*masked_usweep(st.Rhat, mask, v)),
                               lam, row_nnz, nmf)

        for t in range(st.W.shape[0]):
            # K4: deferred subtract of rank t-1 + add-back of rank t, and
            # the first v-sweep with the old u, in one residual pass
            v = new_v(fused_update_vsweep(st.Rhat, mask, st.W[t], st.u_pend,
                                          st.H[t], st.v_pend, order=order))
            u = new_u(v)
            for _ in range(maxinneriter - 1):      # src/CCD.cpp:107-123
                v = new_v(masked_vsweep(st.Rhat, mask, u))
                u = new_u(v)
            # write back (src/CCD.cpp:128-134); the subtract of rank t's new
            # outer product is deferred to rank t+1 via (u_pend, v_pend)
            st.W[t] = u
            st.H[t] = v
            st.u_pend, st.v_pend = u, v
        return st.W

    return step


def rank1_update(R: torch.Tensor, M: Optional[torch.Tensor],
                 u: torch.Tensor, v: torch.Tensor, sign: float) -> None:
    """R += sign·outer(u, v) (times the {0,1} mask ``M``; without one, a
    NaN-sentinel panel absorbs the delta), IN PLACE and in row blocks of
    at most ``UPDATE_BLOCK_CELLS`` cells — elementwise, so the blocking
    does not change a bit. The JAX package's phase-mode update
    (ccd_dense.py::_outer_pass, ccd_hybrid.py::_panel_update): the f32
    delta (·mask) is rounded to R's dtype, then R + delta is rounded again
    (twice at bf16 and fp8, where K1 and K4 round once). An fp8 residual
    adds in f32 and stores through ``round_to_storage``."""
    rows = max(1, UPDATE_BLOCK_CELLS // max(1, R.shape[1]))
    us = u * sign                       # exact: sign is ±1
    for r0 in range(0, R.shape[0], rows):
        blk = R[r0:r0 + rows]
        if R.dtype == FP8:
            d = torch.outer(us[r0:r0 + rows], v)
            if M is not None:
                d.mul_(M[r0:r0 + rows])
            d = rounded_f32(d, FP8)
            d.add_(blk.to(torch.float32))
            store(blk, d)
            del d
            continue
        if M is None:
            # the f32 product rounded once, on the store, to R's dtype
            d = torch.mul(us[r0:r0 + rows, None], v, out=torch.empty_like(blk))
        else:
            d = torch.outer(us[r0:r0 + rows], v).mul_(M[r0:r0 + rows])
            d = d.to(blk.dtype)
        blk.add_(d)
        del d


def make_dense_phase_fns(lam: float, maxinneriter: int, *,
                         nmf: bool = False):
    """Phase-split step functions for phase timing (solvers/phase_loop.py):
    the reference's plain schedule (add-back, sweeps, subtract as separate
    passes, src/CCD.cpp:74-139) — the same math as ``make_outer_step``'s
    fused deferred-subtract schedule, with fenceable phase boundaries.
    Each is ``fn(state, mask, ..., t)`` and updates the state in place;
    the pending outer product is not used."""

    def addback(st: DenseState, mask, t: int) -> None:
        rank1_update(st.Rhat, mask, st.W[t], st.H[t], 1.0)

    def subtract(st: DenseState, mask, t: int) -> None:
        rank1_update(st.Rhat, mask, st.W[t], st.H[t], -1.0)

    def sweeps(st: DenseState, mask, row_nnz, col_nnz, t: int) -> None:
        u, v = st.W[t], st.H[t]
        for _ in range(maxinneriter):          # src/CCD.cpp:107-123
            v = _half_sweep(*masked_vsweep(st.Rhat, mask, u), lam, col_nnz,
                            nmf)
            u = _half_sweep(*masked_usweep(st.Rhat, mask, v), lam, row_nnz,
                            nmf)
        st.W[t] = u
        st.H[t] = v

    return addback, sweeps, subtract


def device_densify(R: RatingMatrix, dtype: torch.dtype, mask_dtype: str,
                   device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (m, n) residual and mask built on ``device`` by one scatter each
    from the COO: ships ~16 B per rating instead of the (m, n) arrays
    (4.5 GB at ml10M dims with an f32 residual and a bf16 mask). The same
    arrays as the JAX package's host-side ``build_dense_inputs``: the mask is
    the observed pattern, so an explicit 0 rating stays observed."""
    r, c, v = R.to_coo()
    return densify_coo_mask(r, c, v, R.rows, R.cols, dtype, mask_dtype,
                            device)


def ccd_dense_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                    T: TestCOO, cfg: Config, *, device="cuda",
                    callback: Optional[Callable[[IterStats], None]] = None,
                    shardings: Optional[dict] = None,
                    ckpt_every: int = 0, ckpt_fn=None, resume=None,
                    rank_callback=None, payload_shape=None,
                    log: Optional[MetricsLog] = None,
                    order: Optional[str] = None,
                    ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train CCD++ with the dense backend on ``device``. Returns (W, H,
    per-iteration stats) in the reference's rank-major layout. ``H0`` is
    accepted for the solvers' common signature; CCD++ zeroes H at entry
    (src/CCD.cpp:56-60). Every ``ckpt_every`` outer iterations
    ``ckpt_fn(oiter, payload)`` gets host copies of the whole training
    state (the JAX payload keys, solvers/dense_state.py: factors, the
    residual AND the pending outer product, since CCD++'s residual is
    state, src/CCD.cpp:100-134), padded with zeros to ``payload_shape``
    when given; ``resume`` (such a payload plus its ``oiter``) continues a
    run after outer iteration ``oiter``. With ``cfg.phase_timing`` the
    phases are fenced and timed apart (``rank_callback(oiter, t, dt,
    rmse)`` per rank). With ``log``, the residual's size and the device
    set-up time are reported as an info line. ``order`` is K4's store
    order (default: the JAX dense step's, ``store_order(dtype, False)``;
    the pallas backend passes "once").

    ``shardings`` (``parallel.mesh.dense_ccd_shardings`` or ``_2d``: this
    rank's block) runs the sharded residual (``_train_sharded``)."""
    check_supported(cfg)
    if cfg.phase_timing:
        refuse_pending(resume)
    dev = resolve_device(device)
    rdt = RESIDUAL_DTYPES[cfg.residual_dtype]
    if order is None:
        order = store_order(rdt, rounds_once=False)
    if shardings is not None:
        return _train_sharded(R, W0, T, cfg, shardings, dev, rdt, order,
                              callback=callback, ckpt_every=ckpt_every,
                              ckpt_fn=ckpt_fn, resume=resume, log=log)
    m, n = R.rows, R.cols

    t0 = time.perf_counter()
    Rd, mask = device_densify(R, rdt, cfg.mask_dtype, dev)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        del Rd
        state = dense_state_from_numpy(resume, (m, n), rdt, dev)
    else:
        zeros = dict(dtype=torch.float32, device=dev)
        state = DenseState(
            Rhat=Rd,
            W=torch.as_tensor(np.asarray(W0, np.float32), device=dev).clone(),
            H=torch.zeros((W0.shape[0], n), **zeros),   # src/CCD.cpp:56-60
            u_pend=torch.zeros(m, **zeros), v_pend=torch.zeros(n, **zeros))
    row_nnz = torch.as_tensor(np.diff(R.csr_ptr).astype(np.float32),
                              device=dev)
    col_nnz = torch.as_tensor(np.diff(R.csc_ptr).astype(np.float32),
                              device=dev)
    synchronize(dev)
    setup_s = time.perf_counter() - t0
    if log is not None:
        nbytes = m * n * (state.Rhat.element_size() + mask.element_size())
        log.info(f"[info] dense residual: {m} x {n} = {m * n} cells, "
                 f"{cfg.residual_dtype} residual + {cfg.mask_dtype} mask, "
                 f"{nbytes / 1e9:.2f} GB; device set-up {setup_s:.3f} s")

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti, tj = i64(T.row_idx), i64(T.col_idx)
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)
    common = dict(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        do_rmse=lambda: calrmse_device(ti, tj, tv, state.W, state.H,
                                       entity_major=False, chunk=chunk),
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=lambda: dense_state_to_numpy(state, shape=payload_shape),
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)

    if cfg.phase_timing:
        ab, sw, sub = make_dense_phase_fns(cfg.lambda_, cfg.maxinneriter,
                                           nmf=cfg.do_nmf)
        stats = phased_ccd_loop(
            k=W0.shape[0], device=dev,
            addback=lambda t: ab(state, mask, t),
            sweeps=lambda t: sw(state, mask, row_nnz, col_nnz, t),
            subtract=lambda t: sub(state, mask, t),
            get_rank_rows=rank_rows(state),
            ti=np.asarray(T.row_idx), tj=np.asarray(T.col_idx),
            tv=np.asarray(T.val), rank_callback=rank_callback, **common)
    else:
        step = make_outer_step(cfg.lambda_, cfg.maxinneriter, nmf=cfg.do_nmf,
                               order=order)
        stats = pipelined_loop(
            fuse=cfg.fused_outer_iters,
            do_step=lambda: step(state, mask, row_nnz, col_nnz), **common)
    return state.W.cpu().numpy(), state.H.cpu().numpy(), stats


def _train_sharded(R: RatingMatrix, W0: np.ndarray, T: TestCOO, cfg: Config,
                   lay, dev, rdt, order, *, callback=None,
                   ckpt_every: int = 0,
                   ckpt_fn=None, resume=None,
                   log: Optional[MetricsLog] = None):
    """The sharded residual (the JAX package's ccd_dense.py:205-235): each
    sharded axis is padded to a multiple of its mesh dimension with
    all-zero pad entities (zero mask, zero factors: the empty-entity rule,
    src/CCD.cpp:8, keeps them exactly 0); this rank densifies only its
    (mp/a, np/b) block and runs K4 and the masked sweeps on it; the
    v-sweep's column partials are all-reduced over the user axis' group and
    (2-D) the u-sweep's row partials over the item axis' group, one
    all-reduce of the concatenated (g, h) each. The RMSE and the result
    gather the factors; a checkpoint payload is the JAX package's global
    padded arrays, gathered to rank 0 (None on the others)."""
    dev = rank_device(dev)
    (a, b), (i, j) = lay.divs, lay.coord
    m, n = R.rows, R.cols
    mp, np_ = m + (-m) % a, n + (-n) % b
    mb, nb = mp // a, np_ // b
    rs, cs = slice(i * mb, (i + 1) * mb), slice(j * nb, (j + 1) * nb)

    t0 = time.perf_counter()
    r, c, v = R.to_coo()
    keep = (r >= rs.start) & (r < rs.stop) & (c >= cs.start) & (c < cs.stop)
    Rd, mask = densify_coo_mask(r[keep] - rs.start, c[keep] - cs.start,
                                v[keep], mb, nb, rdt, cfg.mask_dtype, dev)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        del Rd
        state = dense_state_from_numpy(
            dense_payload_block(resume, lay.divs, lay.coord), (mb, nb), rdt,
            dev)
    else:
        W0p = np.pad(np.asarray(W0, np.float32), ((0, 0), (0, mp - m)))
        zeros = dict(dtype=torch.float32, device=dev)
        state = DenseState(
            Rhat=Rd, W=torch.as_tensor(W0p[:, rs].copy(), device=dev),
            H=torch.zeros((W0.shape[0], nb), **zeros),  # src/CCD.cpp:56-60
            u_pend=torch.zeros(mb, **zeros), v_pend=torch.zeros(nb, **zeros))

    def degrees(ptr, pad, sl):
        return torch.as_tensor(
            np.pad(np.diff(ptr).astype(np.float32), (0, pad))[sl],
            device=dev)

    row_nnz = degrees(R.csr_ptr, mp - m, rs)
    col_nnz = degrees(R.csc_ptr, np_ - n, cs)
    synchronize(dev)
    if log is not None:
        log.info(f"[info] dense residual sharded {a} x {b}: a {mb} x {nb} "
                 f"block a rank ({m} x {n} padded to {mp} x {np_}); device "
                 f"set-up {time.perf_counter() - t0:.3f} s")

    def reduce_over(group):
        return lambda g, h: all_reduce_pair(g, h, group)

    step = make_outer_step(
        cfg.lambda_, cfg.maxinneriter, nmf=cfg.do_nmf, order=order,
        reduce_v=reduce_over(lay.user_group),
        reduce_u=(reduce_over(lay.item_group)
                  if lay.item_group is not None else _no_reduce))

    def full_W():
        return all_gather_rows(state.W.T, lay.user_group).T

    def full_H():
        if lay.item_group is None:
            return state.H
        return all_gather_rows(state.H.T, lay.item_group).T

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti, tj = i64(T.row_idx), i64(T.col_idx)
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)

    def get_payload():
        parts = gather_arrays(dense_state_to_numpy(state), dev)
        return None if parts is None else dense_payload_assemble(parts,
                                                                 lay.divs)

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters,
        do_step=lambda: step(state, mask, row_nnz, col_nnz),
        do_rmse=lambda: calrmse_device(ti, tj, tv, full_W(), full_H(),
                                       entity_major=False, chunk=chunk),
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    return (full_W().cpu().numpy()[:, :m], full_H().cpu().numpy()[:, :n],
            stats)
