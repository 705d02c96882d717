"""Host training loop shared by the compiled backends.

The port's copy of ``cuda_recommender_tpu/solvers/pipeline.py``. The loop
enqueues ``fuse`` (step, rmse) pairs back to back (device work overlaps
host dispatch), then waits once per group: first for all queued device
work (``torch.cuda.synchronize`` on CUDA; the CPU runs eagerly, so
nothing), then for the RMSE readbacks. So ``rank_time`` is the measured
device work of the group (solver steps and their on-device RMSE evals)
over its iterations. ``rmse_time`` is each iteration's test RMSE alone: on
CUDA the device time between two CUDA events recorded around its
enqueue, read after the group's fence (no fence of its own); on the CPU,
which runs it eagerly, the host clock around it. ``update_time`` stays 0:
the fused rank body cannot split sweep from residual phases without
per-phase fences, which is what phase timing (solvers/phase_loop.py) is
for.

Profiler spans (``utils/timing.py::span``): ``crtpu.step`` around each
``do_step`` (args: the outer iteration), ``crtpu.loop.sync`` around the
fence and the readbacks, ``crtpu.loop.callback`` around the caller's
callback and ``crtpu.loop.checkpoint`` around ``get_payload`` and
``ckpt_fn``; ``do_rmse`` names its own (``crtpu.eval.rmse``).

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
from ..utils.timing import span
from .reference import IterStats, early_stopped


def _timed_rmse(do_rmse: Callable[[], object], device) -> tuple:
    """``do_rmse()`` and its timer: on CUDA a (start, end) pair of CUDA
    events recorded around the enqueue, else its host seconds."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        r = do_rmse()
        end.record(stream)
        return r, (start, end)
    t = time.perf_counter()
    r = do_rmse()
    return r, time.perf_counter() - t


def _seconds(timer) -> float:
    """A ``_timed_rmse`` timer's seconds (after the device's fence)."""
    if isinstance(timer, tuple):
        return timer[0].elapsed_time(timer[1]) / 1e3
    return timer


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
    pending: list[tuple[int, object, object]] = []
    last_tok: list = [None]

    def flush(t0: float) -> float:
        if not pending:
            return t0
        # fence the device work first (see module docstring), then the
        # RMSE readbacks; rank_time ends at the fence
        with span("crtpu.loop.sync"):
            synchronize(last_tok[0].device)
            t_solver = time.perf_counter()
            vals = [(o, float(r), _seconds(timer))
                    for o, r, timer in pending]
        dt_rank = (t_solver - t0) / len(pending)
        for o, v, dt_rmse in vals:
            st = IterStats(oiter=o, rmse=v, rank_time=dt_rank,
                           rmse_time=dt_rmse)
            stats.append(st)
            if callback:
                with span("crtpu.loop.callback"):
                    callback(st)
        pending.clear()
        return time.perf_counter()

    t0 = time.perf_counter()
    for oiter in range(start_oiter, maxiter + 1):
        with span("crtpu.step", {"oiter": oiter}):
            last_tok[0] = do_step()
        pending.append((oiter, *_timed_rmse(do_rmse, last_tok[0].device)))
        at_ckpt = bool(ckpt_every) and oiter % ckpt_every == 0
        if len(pending) >= fuse or at_ckpt or oiter == maxiter:
            t0 = flush(t0)
            if early_stopped(stats, early_stop_eps):
                break
        if at_ckpt and ckpt_fn and get_payload is not None:
            with span("crtpu.loop.checkpoint"):
                ckpt_fn(oiter, get_payload())
            t0 = time.perf_counter()
    return stats
