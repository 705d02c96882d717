"""Phase-split CCD++ training loop (opt-in telemetry mode).

The port of ``cuda_recommender_tpu/solvers/phase_loop.py``. The default
loop (pipeline.py) runs all k ranks of an outer iteration back to back and
waits once, so it cannot split the reference's per-phase timers
(rank_time = the RankOneUpdate sweeps, update_time = the UpdateRating
residual passes, reference src/CCD.cpp:76-139,158). This loop runs each
rank's phases separately and waits for the device after each
(``core/device.py::synchronize``), like the reference's
cudaDeviceSynchronize per kernel (cuda_src/CCD_CUDA.cu:339-381): it trades
throughput for real phase attribution. It also carries the reference's
per-rank residual-RMSE trick (calrmse_r1, src/tools.cpp:250-270): a
host-side float64 test-residual vector gets ``-= Wt·Ht - oldWt·oldHt`` per
rank, so verbose mode prints a per-rank RMSE without a full re-evaluation
(the reference's commented verbose path, src/CCD.cpp:141-148).

Schedule: the reference's own plain order (add-back from oiter 2, sweeps,
immediate subtract) rather than the fused deferred-subtract schedule — the
same math, separable phases.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.device import synchronize
from .reference import IterStats, early_stopped


def refuse_pending(resume) -> None:
    """Phase mode keeps no pending outer product: a checkpoint of the fused
    schedule that holds one cannot resume here (the JAX package's
    check, with its message)."""
    if resume is not None and (np.asarray(resume["u_pend"]).any()
                               or np.asarray(resume["v_pend"]).any()):
        raise ValueError("cannot resume a fused-schedule checkpoint "
                         "(pending outer product) in phase-timing mode")


def rank_rows(state) -> Callable[[int], tuple]:
    """``get_rank_rows`` of a state with rank-major ``W`` and ``H``: host
    COPIES of rank t's rows (on the CPU ``.numpy()`` alone would alias the
    rows that the next phase overwrites)."""
    return lambda t: (state.W[t].to("cpu", copy=True).numpy(),
                      state.H[t].to("cpu", copy=True).numpy())


def phased_ccd_loop(*, start_oiter: int, maxiter: int, k: int,
                    device: torch.device,
                    addback: Callable[[int], None],
                    sweeps: Callable[[int], None],
                    subtract: Callable[[int], None],
                    do_rmse: Callable[[], object],
                    get_rank_rows: Optional[Callable] = None,
                    ti=None, tj=None, tv=None,
                    callback: Optional[Callable[[IterStats], None]] = None,
                    rank_callback: Optional[Callable] = None,
                    ckpt_every: int = 0, ckpt_fn=None,
                    get_payload: Optional[Callable[[], dict]] = None,
                    early_stop_eps: float = 0.0,
                    ) -> list[IterStats]:
    """Each phase thunk enqueues its device work for rank ``t``; the loop
    times it to ``synchronize(device)``. ``get_rank_rows(t) -> (Wt, Ht)``
    returns host copies of rank t's factor rows in the same index space as
    ``ti``/``tj`` (needed only when ``rank_callback`` is set)."""

    def timed(thunk, t):
        t0 = time.perf_counter()
        thunk(t)
        synchronize(device)
        return time.perf_counter() - t0

    resid = None
    if rank_callback is not None:
        # test residual under the CURRENT factors (handles resume; equals
        # the raw test values at a fresh start where H == 0)
        resid = np.asarray(tv, np.float64).copy()
        for t in range(k):
            Wt, Ht = get_rank_rows(t)
            resid -= Wt[ti].astype(np.float64) * Ht[tj].astype(np.float64)

    stats: list[IterStats] = []
    for oiter in range(start_oiter, maxiter + 1):
        rank_t = upd_t = 0.0
        for t in range(k):
            old = get_rank_rows(t) if rank_callback is not None else None
            if oiter > 1:                      # src/CCD.cpp:100-103
                upd_t += timed(addback, t)
            dt_sweep = timed(sweeps, t)
            rank_t += dt_sweep
            dt_sub = timed(subtract, t)
            upd_t += dt_sub
            if rank_callback is not None:
                Wt, Ht = get_rank_rows(t)
                resid -= (Wt[ti].astype(np.float64) * Ht[tj].astype(np.float64)
                          - old[0][ti].astype(np.float64)
                          * old[1][tj].astype(np.float64))
                rank_rmse = float(np.sqrt(np.mean(resid * resid)))
                rank_callback(oiter, t, dt_sweep + dt_sub, rank_rmse)
        t0 = time.perf_counter()
        rmse = float(do_rmse())
        st = IterStats(oiter=oiter, rmse=rmse, rank_time=rank_t,
                       update_time=upd_t,
                       rmse_time=time.perf_counter() - t0)
        stats.append(st)
        if callback:
            callback(st)
        if ckpt_every and ckpt_fn and get_payload is not None \
                and oiter % ckpt_every == 0:
            ckpt_fn(oiter, get_payload())
        if early_stopped(stats, early_stop_eps):
            break
    return stats
