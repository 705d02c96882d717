"""Train CLI — reference flag semantics on the PyTorch + CUDA port.

The port of ``cuda_recommender_tpu/cli/train.py`` for the flags of its
slice: ``-k -l -t -T -ALS`` (reference src/extras.cpp:46-141),
``-OMP/--golden`` (also run the NumPy golden solver and cross-validate,
src/main.cpp:109-144), ``--backend``, ``--dataset
synthetic:m=...,n=...,nnz=...``, the hybrid panel knobs (with
``--transpose-stair 0|1|auto``), the ALS layout
knobs, ``--seed``, ``--metrics-file`` and ``--device``. Knobs outside the
slice raise ``NotImplementedError`` from the trainer.

    python -m cuda_recommender_tpu_torch.cli.train \\
        --dataset synthetic:m=6040,n=3706,nnz=900000 -k 10 -t 5 -l 0.05 \\
        --golden
    python -m cuda_recommender_tpu_torch.cli.train \\
        --dataset synthetic:m=6040,n=3706,nnz=900000 -k 10 -t 3 \\
        --backend hybrid --mask-dtype nan --panel-kernel --golden
    python -m cuda_recommender_tpu_torch.cli.train \\
        --dataset synthetic:m=6040,n=3706,nnz=900000 -k 10 -t 3 -ALS --golden

On a CUDA device the run ends with one line of kernel launch counts
(``[info] kernel launches: {...}``).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..core.config import Backend, Config, Solver
from ..core.metrics_log import MetricsLog
from ..core.trainer import train
from ..data import datasets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.cli.train",
        description="CCD++/ALS matrix-factorization trainer "
                    "(PyTorch + CUDA)")
    # reference knobs (src/pmf.h:26-42 defaults)
    p.add_argument("-k", type=int, default=10, help="rank (default 10)")
    p.add_argument("-l", type=float, default=0.1, dest="lambda_",
                   help="regularization lambda (default 0.1)")
    p.add_argument("-t", type=int, default=5, dest="maxiter",
                   help="outer iterations (default 5)")
    p.add_argument("-T", type=int, default=1, dest="maxinneriter",
                   help="inner iterations (default 1)")
    p.add_argument("-ALS", action="store_true", dest="als",
                   help="use ALS instead of CCD++")
    p.add_argument("-OMP", "--golden", action="store_true", dest="golden",
                   help="also run the golden NumPy backend and cross-validate")
    p.add_argument("--backend", default="auto",
                   choices=[b.value for b in Backend],
                   help="CCD++: 'dense' (AUTO's choice for m*n <= "
                        "Config.dense_max_cells), 'pallas' (dense with a "
                        "bf16 mask), 'hybrid' (AUTO's choice above) or "
                        "'ref'; 'ell' is not in the port yet. ALS: 'ell' "
                        "(any request but 'ref' resolves to it) or 'ref'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--residual-dtype", default="float32",
                   choices=["float32", "bfloat16", "float8_e4m3fn"])
    p.add_argument("--mask-dtype", default="bfloat16",
                   choices=["bfloat16", "int8", "nan"],
                   help="residual mask storage: 'bfloat16' or 'int8' (a "
                        "{0,1} array beside the residual; dense and hybrid), "
                        "or 'nan' (hybrid only: no mask array, unobserved "
                        "panel cells are NaN in the residual)")
    p.add_argument("--hybrid-cells", type=int, default=None, metavar="N",
                   help="hybrid panel-stair cell budget "
                        "(default Config.hybrid_dense_cells)")
    p.add_argument("--panel-widths", default=None, metavar="W1,W2|auto",
                   help="hybrid panel-stair widths: comma list (e.g. "
                        "'4096,2048') or 'auto' for the data-driven stair")
    p.add_argument("--panel-kernel", action="store_true", dest="panel_kernel",
                   help="run the hybrid panels through the fused panel "
                        "kernels (requires --mask-dtype nan)")
    p.add_argument("--transpose-stair", default=None, metavar="0|1|auto",
                   dest="transpose_stair", choices=["0", "1", "auto"],
                   help="hybrid stair orientation: 1 plans panels over top-"
                        "ITEMS x user prefixes (the transposed matrix), "
                        "'auto' plans both and keeps the smaller uncovered "
                        "tail")
    p.add_argument("--als-min-width", default=None, metavar="W|auto",
                   dest="als_min_width",
                   help="ALS ELL bucket width floor: integer or 'auto' for "
                        "the degree-adaptive floor (default "
                        "Config.als_min_width)")
    p.add_argument("--als-group-mb", type=int, default=None, metavar="MB",
                   dest="als_group_mb",
                   help="per-group device-memory temp budget of the grouped "
                        "ALS gram assembly and solve")
    p.add_argument("--als-gather-tile-mb", type=float, default=None,
                   metavar="MB", dest="als_gather_tile_mb",
                   help="gather-cliff tiling threshold (0 disables; default "
                        "Config.als_gather_tile_mb); the port runs untiled "
                        "and says so where the JAX package would tile")
    p.add_argument("--dataset", required=True,
                   help="synthetic:m=...,n=...,nnz=...[,seed=...] generator")
    p.add_argument("--metrics-file", default=None, help="JSONL metrics sink")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    widths = None
    if args.panel_widths is not None:
        widths = ("auto" if args.panel_widths == "auto" else
                  tuple(int(w) for w in args.panel_widths.split(",") if w))
    overrides = {}
    if args.hybrid_cells is not None:
        overrides["hybrid_dense_cells"] = int(args.hybrid_cells)
    if widths is not None:
        overrides["hybrid_panel_widths"] = widths
    if args.transpose_stair is not None:
        overrides["hybrid_transpose"] = (
            "auto" if args.transpose_stair == "auto"
            else bool(int(args.transpose_stair)))
    if args.als_min_width is not None:
        overrides["als_min_width"] = ("auto" if args.als_min_width == "auto"
                                      else int(args.als_min_width))
    if args.als_group_mb is not None:
        overrides["als_group_mb"] = int(args.als_group_mb)
    if args.als_gather_tile_mb is not None:
        overrides["als_gather_tile_mb"] = float(args.als_gather_tile_mb)
    cfg = Config(
        solver=Solver.ALS if args.als else Solver.CCD, k=args.k,
        maxiter=args.maxiter, maxinneriter=args.maxinneriter,
        lambda_=args.lambda_, backend=Backend(args.backend),
        golden=args.golden, seed=args.seed,
        residual_dtype=args.residual_dtype, mask_dtype=args.mask_dtype,
        hybrid_panel_kernel=args.panel_kernel,
        metrics_file=args.metrics_file, **overrides)
    R, T = datasets.synthetic_from_spec(args.dataset)
    print(f"[info] loaded {R.rows} x {R.cols}, nnz={R.nnz}, "
          f"test nnz={T.nnz}", flush=True)

    log = MetricsLog(cfg.metrics_file)
    try:
        train(cfg, R, T, device=args.device, log=log)
    finally:
        log.close()
    if args.device.startswith("cuda"):
        from ..ops.launches import launch_counts
        print("[info] kernel launches: " + json.dumps(launch_counts()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
