"""Host training loop shared by the compiled backends.

The port's copy of ``cuda_recommender_tpu/solvers/pipeline.py``. The loop
enqueues ``fuse`` (step, rmse) pairs back to back (device work overlaps
host dispatch), then waits once per group: first for all queued device
work (``torch.cuda.synchronize`` on CUDA; the CPU runs eagerly, so
nothing), then for the RMSE readbacks. So ``rank_time`` is the measured
device work of the group (solver steps and their on-device RMSE evals) and
``rmse_time`` the readbacks alone. ``update_time`` stays 0: the
fused rank body cannot split sweep from residual phases without per-phase
fences, which is what phase timing (solvers/phase_loop.py) is for.

Checkpoints: every ``ckpt_every`` outer iterations the group is flushed
(so the state is final), then ``ckpt_fn(oiter, get_payload())`` writes
the host copy of the state. The save is not charged to any iteration's
``rank_time``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..core.device import synchronize
from .reference import IterStats, early_stopped


def pipelined_loop(*, start_oiter: int, maxiter: int, fuse: int,
                   do_step: Callable[[], torch.Tensor],
                   do_rmse: Callable[[], object],
                   callback: Optional[Callable[[IterStats], None]] = None,
                   ckpt_every: int = 0, ckpt_fn=None,
                   get_payload: Optional[Callable[[], dict]] = None,
                   early_stop_eps: float = 0.0,
                   ) -> list[IterStats]:
    """Run outer iterations ``start_oiter..maxiter``; ``do_step`` returns a
    tensor on the training device (its W), ``do_rmse`` a 0-d tensor.
    ``early_stop_eps`` > 0 ends the loop once the relative RMSE
    improvement drops below it — checked at flush boundaries, so with
    ``fuse`` > 1 up to fuse-1 extra iterations may run before the stop
    (an iteration that stops the run writes no checkpoint)."""
    fuse = max(1, fuse)
    stats: list[IterStats] = []
    pending: list[tuple[int, object]] = []
    last_tok: list = [None]

    def flush(t0: float) -> float:
        if not pending:
            return t0
        # fence the device work first (see module docstring), then the
        # RMSE readbacks, so rank_time / rmse_time are separately measured
        if last_tok[0] is not None:
            synchronize(last_tok[0].device)
        t_solver = time.perf_counter()
        vals = [(o, float(r)) for o, r in pending]
        t_end = time.perf_counter()
        n = len(pending)
        dt_rank = (t_solver - t0) / n
        dt_rmse = (t_end - t_solver) / n
        for o, v in vals:
            st = IterStats(oiter=o, rmse=v, rank_time=dt_rank,
                           rmse_time=dt_rmse)
            stats.append(st)
            if callback:
                callback(st)
        pending.clear()
        return time.perf_counter()

    t0 = time.perf_counter()
    for oiter in range(start_oiter, maxiter + 1):
        last_tok[0] = do_step()
        pending.append((oiter, do_rmse()))
        at_ckpt = bool(ckpt_every) and oiter % ckpt_every == 0
        if len(pending) >= fuse or at_ckpt or oiter == maxiter:
            t0 = flush(t0)
            if early_stopped(stats, early_stop_eps):
                break
        if at_ckpt and ckpt_fn and get_payload is not None:
            ckpt_fn(oiter, get_payload())
            t0 = time.perf_counter()
    return stats
