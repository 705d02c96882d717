"""What one collective of the sharded paths costs the host, on the card.

    python -m cuda_recommender_tpu_torch.scripts.collective_overhead

In this process a world of one rank (``parallel/multihost.py::
initialize_local``) over NCCL, then over gloo (which the two ranks on one
card use), times each collective wrapper of ``parallel/collectives.py`` at
the sharded ELL's table size (ml10M's 69,878 slots x 3 columns, f32) and
at the hybrid's (g, h) size (2 x 480,189), beside a device copy of the
same bytes:

* ``idle_us``: host microseconds a call, the device idle (mean of
  ``REPS`` back-to-back calls, fenced once at the end);
* ``behind_ms``: host milliseconds of ONE call issued behind ``QUEUED_MS``
  of queued device work (``torch.cuda._sleep``). A call that returns at
  once shows ~0; one that waits for the device shows about the queued
  time: such a call serializes a host-bound loop (one dispatch after
  another) with its device work.

Then, over NCCL, the pure-ELL outer step at ml10M dims (k = 10) on one
device and sharded over the world of one rank (its table hook an
all-gather), in turns (one, sharded, sharded, one): host wall ms a step
(mean of ``STEPS``, fenced), and one traced step each under torch.profiler
(scripts/profile_iteration.py::profile_split: device busy ms and idle
share of the span).

Prints one JSON line (with the card's name and power limit). On the CPU
(``--device cpu``) the calls run once over gloo, the ELL steps at a small
size, and no time is reported.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..core.device import resolve_device, synchronize
from ..core.init import init_factors_np
from ..data.datasets import synthetic_cached
from ..data.ell import build_ell_pair
from ..parallel import collectives, multihost
from ..parallel.ccd_ell_sharded import initial_payload, local_pair
from ..solvers.ccd_ell import make_ell_outer_step, side_tiles
from ..solvers.ell_state import ell_state_from_numpy
from .common import card
from .profile_iteration import profile_split

#: back-to-back calls a mean is taken over; device work queued ahead of
#: the blocking probe
REPS = 200
QUEUED_MS = 50.0
#: (rows, columns) f32: the sharded ELL's gathered table at ml10M dims and
#: the hybrid's concatenated (g, h) at Netflix-100M dims
SHAPES = {"ell_table": (69_878, 3), "hybrid_gh": (480_189, 2)}
#: the pure-ELL step's data (the README quick start's ml10M dims, k = 10;
#: a small size on the CPU) and the untraced steps a wall time is taken over
ELL = dict(m=69_878, n=10_677, nnz=10_000_000, k=10, lam=0.05)
ELL_CPU = dict(m=300, n=120, nnz=6_000, k=4, lam=0.05)
STEPS = 5


def _cycles_for(ms: float, device) -> int:
    """``torch.cuda._sleep`` cycles that keep the card busy ``ms``."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    probe = 10_000_000
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    torch.cuda.synchronize(device)
    return int(probe * ms / start.elapsed_time(end))


def measure(device, backend: str) -> dict:
    multihost.initialize_local(device, backend=backend)
    try:
        out = {}
        cycles = _cycles_for(QUEUED_MS, device) if device.type == "cuda" \
            else 0
        for name, (rows, cols) in SHAPES.items():
            x = torch.randn(rows, cols, device=device)
            y = torch.empty_like(x)
            calls = {"copy": lambda: y.copy_(x),
                     "all_gather_rows": lambda: collectives.all_gather_rows(x),
                     "all_reduce_pair": lambda: collectives.all_reduce_pair(
                         x[:, 0], x[:, 1])}
            for op, fn in calls.items():
                fn()
                if device.type != "cuda":
                    out[f"{name}/{op}"] = None
                    continue
                torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                for _ in range(REPS):
                    fn()
                idle_us = 1e6 * (time.perf_counter() - t0) / REPS
                torch.cuda.synchronize(device)
                torch.cuda._sleep(cycles)
                t0 = time.perf_counter()
                fn()
                behind_ms = 1e3 * (time.perf_counter() - t0)
                torch.cuda.synchronize(device)
                out[f"{name}/{op}"] = dict(idle_us=idle_us,
                                           behind_ms=behind_ms)
        return out
    finally:
        multihost.shutdown()


def ell_steps(device, m, n, nnz, k, lam) -> dict:
    """The pure-ELL outer step on one device and through the sharded
    step's all-gather hook (a world of one rank over NCCL), in turns."""
    R, _ = synthetic_cached(m, n, nnz, seed=1)
    ell = build_ell_pair(R, min_width=8, num_shards=1)
    W0, _ = init_factors_np(k, m, n, seed=0)
    dev = multihost.initialize_local(device)
    try:
        steps = {}
        for name, gather in (("one_device", None),
                             ("sharded_1_rank", collectives.all_gather_rows)):
            st = ell_state_from_numpy(initial_payload(ell, W0),
                                      local_pair(ell, 0), dev)
            step = make_ell_outer_step(
                ell, side_tiles(ell.rows_side, dev),
                side_tiles(ell.cols_side, dev),
                torch.as_tensor(ell.rows_side.slot_nnz, device=dev),
                torch.as_tensor(ell.cols_side.slot_nnz, device=dev), lam, 1,
                gather=gather)
            steps[name] = lambda step=step, st=st: step(st)
        out = {name: {"wall_ms": []} for name in steps}
        for name in ("one_device", "sharded_1_rank", "sharded_1_rank",
                     "one_device"):
            steps[name]()
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(STEPS):
                steps[name]()
            synchronize(dev)
            out[name]["wall_ms"].append(
                1e3 * (time.perf_counter() - t0) / STEPS)
        for name, fn in steps.items():
            prof = profile_split(fn, dev, warm=1)
            out[name]["traced"] = {key: prof[key] for key in (
                "wall_ms", "span_ms", "busy_ms", "idle_pct")}
            out[name]["top_kernels"] = prof["kernels"][:6]
        if dev.type != "cuda":          # host times of the CPU: not reported
            out = {name: None for name in out}
        return out
    finally:
        multihost.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.collective_overhead")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = multihost.rank_device(resolve_device(args.device))
    backends = ("nccl", "gloo") if device.type == "cuda" else ("gloo",)
    rec = {"queued_ms": QUEUED_MS, "reps": REPS, "shapes": SHAPES,
           "device": card(device)}
    for backend in backends:
        rec[backend] = measure(device, backend)
    rec["ell_step"] = ell_steps(device, **(ELL if device.type == "cuda"
                                          else ELL_CPU))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
