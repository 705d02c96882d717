"""One steady outer iteration of a training configuration under
torch.profiler: device time by kernel name, the device span, busy time and
idle share.

    python -m cuda_recommender_tpu_torch.scripts.profile_iteration

Three configurations, in turn: the port's bench headline (``bench.py``:
Netflix-100M dims, k = 40, bf16 NaN-sentinel panels, hand stair (4096, 2048)
under 6.5e9 cells; K1, K2 and the ELL tail), the JAX README's quick start
(ml10M dims, k = 10, f32 residual, bf16 mask; K4 and masked_usweep), and
the ALS headline (``scripts/bench_als_tpu.py:76-79``: ml20M dims, k = 40,
λ = 0.1; the gathers, the gram ``bmm`` and K5; the step alone, without the
trainer's RMSE) at each ``--als-precisions`` (default "highest"; the ALS
lines add the split into the gram products, the gathers and K5). Each runs
two untraced outer iterations, then one traced. Prints one line per kernel
name and a JSON summary per configuration as its last line.

    python -m cuda_recommender_tpu_torch.scripts.profile_iteration \
        --configs als --als-precisions highest,high,default
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.init import init_factors_np
from ..data.datasets import synthetic_cached
from .common import card

#: the README quick start's configuration (ml10M dims)
DENSE = dict(m=69_878, n=10_677, nnz=10_000_000, k=10, lam=0.05)
#: bench.py's headline arguments (its defaults)
HYBRID_ARGS: list = []
#: the JAX package's ALS headline (scripts/bench_als_tpu.py:76-79)
ALS = dict(m=138_493, n=26_744, nnz=20_000_000, k=40, lam=0.1)


def hybrid_step(device):
    """The bench headline's outer step and its state, set up as
    ``ccd_hybrid_train`` sets them up."""
    from .. import bench
    from ..solvers import ccd_hybrid as ch

    args = bench.build_parser().parse_args(HYBRID_ARGS)
    cfg = bench.config(args)
    R, _ = synthetic_cached(args.m, args.n, args.nnz, seed=args.seed,
                            test_fraction=0.02)
    plan = ch.plan_hybrid(R, cfg, materialize_dense=False)
    W0, _ = init_factors_np(cfg.k, R.rows, R.cols, seed=cfg.seed)
    st = ch.initial_state(plan, W0, torch.bfloat16, device, "nan")
    step = ch.make_hybrid_outer_step(plan, ch.device_plan(plan, device),
                                     cfg.lambda_, cfg.maxinneriter,
                                     order="once")     # bf16 stores once
    return lambda: step(st), f"hybrid {list(plan.panels)}, k={cfg.k}"


def dense_step(device, m, n, nnz, k, lam):
    """The dense backend's outer step at (m, n, nnz), f32 residual and bf16
    mask, from the trainer's initial state."""
    from ..solvers import ccd_dense as cd

    R, _ = synthetic_cached(m, n, nnz, seed=1)
    Rd, mask = cd.device_densify(R, torch.float32, "bfloat16", device)
    W0, _ = init_factors_np(k, R.rows, R.cols, seed=0)
    zeros = dict(dtype=torch.float32, device=device)
    st = cd.DenseState(Rhat=Rd, W=torch.as_tensor(W0, device=device),
                       H=torch.zeros((k, R.cols), **zeros),
                       u_pend=torch.zeros(R.rows, **zeros),
                       v_pend=torch.zeros(R.cols, **zeros))
    rnz = torch.as_tensor(np.diff(R.csr_ptr).astype(np.float32),
                          device=device)
    cnz = torch.as_tensor(np.diff(R.csc_ptr).astype(np.float32),
                          device=device)
    step = cd.make_outer_step(lam, 1, order="once")     # f32 stores once
    return (lambda: step(st, mask, rnz, cnz),
            f"dense {m}x{n}, k={k}, f32 residual, bf16 mask")


def als_step(device, m, n, nnz, k, lam, precision="highest"):
    """The ALS headline's outer step (solver gj: K5) from the trainer's
    initial state at gram ``precision``, set up as ``als_ell_train`` sets
    it up."""
    from ..core.config import Config
    from ..data.ell import build_ell_pair
    from ..solvers import als_ell
    from ..solvers.als_state import als_state_from_numpy, slot_payload

    cfg = Config(solver="als", k=k, lambda_=lam, als_solver="gj")
    R, _ = synthetic_cached(m, n, nnz, seed=1, test_fraction=0.02)
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=cfg.seed,
                             entity_major=True)
    ell = build_ell_pair(R, min_width=cfg.als_min_width)
    idx_r, vals_r = als_ell.side_tensors(ell.rows_side, device)
    idx_c, vals_c = als_ell.side_tensors(ell.cols_side, device)
    nnz_r = torch.as_tensor(ell.rows_side.slot_nnz, device=device)
    nnz_c = torch.as_tensor(ell.cols_side.slot_nnz, device=device)
    W, H = als_state_from_numpy(slot_payload(ell, W0, H0), ell, device)
    step = als_ell.make_als_outer_step(ell, lam, solver="gj",
                                       precision=precision)
    return (lambda: step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c),
            f"als {m}x{n}, nnz {nnz}, k={k}, solver gj, precision "
            f"{precision}")


#: the ALS step's kernels by part: the f32 gram kernel (``als_gram``, its
#: segments' sum included), the bf16 gram products (cuBLAS' Hopper
#: kernels; its f32 SIMT kernels where the plain f32 path runs), the
#: gathers ``table[idx]`` (aten::index's kernels) and K5; the rest (casts,
#: the rating column's copy, λ, the zeroing of empty slots) is "other"
ALS_PARTS = (("gram", re.compile(r"als_gram")),
             ("bmm", re.compile(r"gemm|nvjet|xmma|cutlass")),
             ("gather", re.compile(r"index|gather")),
             ("gj_solve", re.compile(r"gj_")))


def kernel_split(out: dict, parts=ALS_PARTS, rest: str = "other") -> dict:
    """ms of a ``trace_split``'s kernels by ``parts`` ((name, pattern)
    pairs: a kernel goes to the first whose pattern its name matches), and
    ``rest``."""
    split = {name: 0.0 for name, _ in parts}
    split[rest] = 0.0
    for name, ms, _ in out["kernels"]:
        split[next((p for p, rx in parts if rx.search(name)), rest)] += ms
    return split


def profiler(device):
    """A torch.profiler context tracing the host and, on the card, the
    device."""
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                   if device.type == "cuda" else [ProfilerActivity.CPU])


def profile_split(step, device, warm: int = 2) -> dict:
    """``step`` ``warm`` times untraced, then once under torch.profiler:
    ``trace_split`` of that trace, and ``untraced_s``, the host seconds of
    each untraced call up to ``torch.cuda.synchronize()`` (the first pays
    the kernels' first launches)."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    untraced = []
    for _ in range(warm):
        t0 = time.perf_counter()
        step()
        sync()
        untraced.append(time.perf_counter() - t0)
    with profiler(device) as prof:
        t0 = time.perf_counter()
        step()
        sync()
        wall = time.perf_counter() - t0
    return dict(trace_split(prof, wall), untraced_s=untraced)


def trace_split(prof, wall: float) -> dict:
    """Of a finished profiler trace taken over ``wall`` host seconds: host
    wall ms, the device span from the first kernel's start to the last
    one's end, busy ms (the union of kernel intervals), the idle share of
    the span, and [name, ms, launches] per kernel name by time."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    by_name: dict = {}
    for e in kernels:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, cnt + 1)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    span = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    busy /= 1e3
    return {"wall_ms": 1e3 * wall, "span_ms": span, "busy_ms": busy,
            "idle_pct": 100 * (1 - busy / span) if span else None,
            "kernels": [[name, ms, cnt] for name, (ms, cnt) in
                        sorted(by_name.items(), key=lambda x: -x[1][0])]}


def report(what: str, out: dict) -> None:
    idle = out["idle_pct"]
    print(f"[profile] one {what} outer iteration: host wall "
          f"{out['wall_ms']:.3f} ms; device span {out['span_ms']:.3f} ms, "
          f"kernels busy {out['busy_ms']:.3f} ms, idle "
          f"{'not measured' if idle is None else f'{idle:.2f}%'} of the "
          "span", flush=True)
    for name, ms, cnt in out["kernels"]:
        share = 100 * ms / out["busy_ms"] if out["busy_ms"] else 0.0
        print(f"[profile]   {ms:9.3f} ms {share:5.1f}% {cnt:5d} launches  "
              f"{name[:90]}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.scripts.profile_iteration",
        description="one steady outer iteration under torch.profiler")
    p.add_argument("--device", default="cuda")
    p.add_argument("--configs", default="hybrid,dense,als",
                   help="comma-separated: hybrid, dense, als")
    p.add_argument("--als-precisions", default="highest",
                   help="comma-separated als_precision values of the ALS "
                        "configuration")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    runs = [(which, None) for which in args.configs.split(",")
            if which != "als"]
    if "als" in args.configs.split(","):
        runs += [("als", prec) for prec in args.als_precisions.split(",")]
    for which, prec in runs:
        step, what = (hybrid_step(device) if which == "hybrid"
                      else dense_step(device, **DENSE) if which == "dense"
                      else als_step(device, **ALS, precision=prec))
        out = profile_split(step, device)
        del step
        report(what, out)
        if which == "als":
            out["parts_ms"] = kernel_split(out)
            print("[profile]   by part: " + ", ".join(
                f"{part} {ms:.3f} ms" for part, ms in
                out["parts_ms"].items()), flush=True)
        print(json.dumps({"config": which, "what": what,
                          "device": card(device), **out}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
