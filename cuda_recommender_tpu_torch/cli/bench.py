"""Benchmark sweep CLI — the reference's scripts/times.sh grid (k in
{1,5,10,15,20,25,30,40,50} x inner iterations T in {1,3,5,7} x repeats)
as one command emitting a JSONL record per (solver, k, T, repeat), with the
per-iteration timing and the final RMSE: the port of
``cuda_recommender_tpu/cli/bench.py``.

    python -m cuda_recommender_tpu_torch.cli.bench --ks 10,40 \\
        --solvers ccd,als [--device cuda]

Each point runs the path ``train()`` runs (``core/trainer.py::solve``) on
the device, or the NumPy reference for ``--backend ref``. ``--dataset`` is
a synthetic spec or a ``meta_modified_all`` dataset directory.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..core.config import Backend, Config, Solver
from ..core.device import resolve_device
from ..core.init import init_factors_np
from ..core.trainer import check_supported, solve
from ..data import datasets


def run_once(R, T, solver: Solver, backend: Backend, k: int, inner: int,
             lam: float, iters: int, seed: int, device,
             cfg_extra: dict = None) -> dict:
    """One grid point: train, and its record."""
    from ..solvers.reference import als_reference, ccd_reference

    cfg = Config(solver=solver, k=k, maxiter=iters, maxinneriter=inner,
                 lambda_=lam, backend=backend, seed=seed,
                 **(cfg_extra or {}))
    backend = cfg.resolve_backend(R.rows, R.cols)   # normalizes ALS -> ELL
    check_supported(cfg, backend)
    entity_major = solver == Solver.ALS
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=seed,
                             entity_major=entity_major)
    t0 = time.perf_counter()
    if backend == Backend.REF:
        if solver == Solver.ALS:
            stats = als_reference(R, W0, H0, T, lambda_=lam, maxiter=iters)
        else:
            stats = ccd_reference(R, W0, H0, T, lambda_=lam, maxiter=iters,
                                  maxinneriter=inner)
    else:
        _, _, stats = solve(cfg, backend, R, W0, H0, T, device=device)
    total = time.perf_counter() - t0
    # steady-state iteration time: skip the first two iterations (set-up
    # and the kernels' first launches); the NumPy reference does not time
    # itself, so it falls back to the wall total
    steady = [s.rank_time for s in stats[2:]] or [s.rank_time for s in stats]
    iter_s = sum(steady) / len(steady) if steady else 0.0
    if iter_s <= 0:
        iter_s = total / max(1, len(stats))
    return {
        "solver": solver.value, "backend": backend.value, "k": k,
        "inner": inner, "lambda": lam, "iters": iters,
        "total_s": total, "iter_s": iter_s,
        "final_rmse": stats[-1].rmse if stats else None,
        # rating_updates_per_s = nnz * k / iter_s (CCD++ sweeps touch every
        # rating once per rank); ratings_per_s = nnz / iter_s (ALS visits
        # every rating once per side)
        "rating_updates_per_s": R.nnz * k / iter_s if iter_s else None,
        "ratings_per_s": R.nnz / iter_s if iter_s else None,
        "device": str(device),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cuda_recommender_tpu_torch.cli.bench")
    p.add_argument("--dataset", default="synthetic:m=6040,n=3706,nnz=900000",
                   help="synthetic:m=...,n=...,nnz=...[,seed=...] spec")
    p.add_argument("--ks", default="10,40",
                   help="comma list (reference grid: 1,5,10,15,20,25,30,40,50)")
    p.add_argument("--inners", default="1", help="comma list (ref: 1,3,5,7)")
    p.add_argument("--solvers", default="ccd,als")
    p.add_argument("--backend", default="auto",
                   choices=[b.value for b in Backend])
    p.add_argument("--lambda", dest="lam", type=float, default=0.1)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--repeats", type=int, default=1)
    p.add_argument("--seed", type=int, default=0,
                   help="factor-init seed, FIXED across repeats (reference "
                        "srand(0) discipline, src/tools.cpp:155-173; repeats "
                        "measure run variance, not seed sensitivity)")
    p.add_argument("--vary-seed", action="store_true",
                   help="seed = repeat index, so repeats measure seed "
                        "sensitivity instead of run variance")
    # hybrid-backend knobs, so the grid can run the headline's flavour
    # (--residual-dtype bfloat16 --mask-dtype nan --budget 6500000000
    # --panel-widths 4096,2048 --panel-kernel)
    p.add_argument("--budget", type=int, default=None,
                   help="hybrid_dense_cells")
    p.add_argument("--panel-widths", default=None,
                   help="'auto' or comma list, e.g. 4096,2048")
    p.add_argument("--residual-dtype", default=None)
    p.add_argument("--mask-dtype", default=None)
    p.add_argument("--panel-kernel", action="store_true")
    p.add_argument("-o", "--output", default=None, help="JSONL output path")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; no card is an error) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}; pass --device cpu to run on the CPU",
              file=sys.stderr)
        return 2
    cfg_extra = {}
    if args.budget is not None:
        cfg_extra["hybrid_dense_cells"] = args.budget
    if args.panel_widths is not None:
        cfg_extra["hybrid_panel_widths"] = (
            "auto" if args.panel_widths == "auto"
            else tuple(int(w) for w in args.panel_widths.split(",")))
    if args.residual_dtype is not None:
        cfg_extra["residual_dtype"] = args.residual_dtype
    if args.mask_dtype is not None:
        cfg_extra["mask_dtype"] = args.mask_dtype
    if args.panel_kernel:
        cfg_extra["hybrid_panel_kernel"] = True

    if args.dataset.startswith("synthetic:"):
        R, T = datasets.synthetic_from_spec(args.dataset)
    else:
        from ..data import binfmt
        R, T = binfmt.load_binary_dataset(args.dataset)

    sink = open(args.output, "a") if args.output else None
    try:
        inners = [int(x) for x in args.inners.split(",")]
        for solver in args.solvers.split(","):
            for k in map(int, args.ks.split(",")):
                for inner in inners:
                    if solver == "als" and inner != inners[0]:
                        continue        # inner iterations are CCD-only
                    for rep in range(args.repeats):
                        seed = rep if args.vary_seed else args.seed
                        rec = run_once(R, T, Solver(solver),
                                       Backend(args.backend), k, inner,
                                       args.lam, args.iters, seed, device,
                                       cfg_extra)
                        rec["repeat"] = rep
                        rec["seed"] = seed
                        if cfg_extra:
                            rec["cfg"] = {key: (list(v) if isinstance(v, tuple)
                                                else v)
                                          for key, v in cfg_extra.items()}
                        line = json.dumps(rec)
                        print(line, flush=True)
                        if sink:
                            sink.write(line + "\n")
                            sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
