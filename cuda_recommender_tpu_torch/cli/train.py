"""Train CLI — reference flag semantics on the PyTorch + CUDA port.

The port of ``cuda_recommender_tpu/cli/train.py``. It mirrors the reference
CLI (reference src/extras.cpp:46-141): ``-k -n -l -t -T -e -p -q -N -ALS``
plus the positional ``data_dir``; ``-OMP/--golden`` also runs the NumPy
golden solver and cross-validates (src/main.cpp:109-144); ``-CUDA``,
``-nBlocks`` and ``-nThreadsPerBlock`` are accepted for the reference's
scripts and set nothing (the compiled backend runs by default, and each
kernel picks its own launch geometry). Then ``--backend``, the hybrid panel
knobs (with ``--transpose-stair 0|1|auto``), the ALS layout knobs,
``--fused-iters``, ``--early-stop``, ``--seed``, ``--metrics-file``,
``--save-model``, ``--device``, checkpoints (``--checkpoint-dir``,
``--checkpoint-every``, ``--resume``) and ``--phase-timing`` (fenced
per-phase rank/update times; with ``-q 1`` a line per rank).

``--mesh N`` shards the run over N RANKS, one process a GPU, under
``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); it raises unless
``WORLD_SIZE`` is N. (In the JAX package ``--mesh N`` is N devices of one
process.) ``--mesh2d AxB`` is the dense backend's (users x items) mesh of
A·B ranks. NCCL runs the collectives on the card and gloo on the CPU
(``--dist-backend`` picks another). Every rank loads the data and ends
with the same factors; rank 0 alone prints the iteration lines and the
golden verdict and writes ``--save-model``, the predictions and the
metrics file.

    torchrun --nproc-per-node 4 -m cuda_recommender_tpu_torch.cli.train \
        --mesh 4 --dataset synthetic:m=6040,n=3706,nnz=900000 -k 10 -t 3 \
        --backend hybrid --mask-dtype nan --panel-kernel

Data: a ``data_dir`` holding ``meta_modified_all`` (the reference's packed
binary, src/tools.cpp:3-85) or ``meta`` (legacy text, src/extras.cpp:24-44),
or ``--dataset synthetic:m=...,n=...,nnz=...``. ``-p 1`` saves the model
(``--save-model`` or ``./model``) and writes one prediction a test rating
to ``./output``.

    python -m cuda_recommender_tpu_torch.cli.train \\
        --dataset synthetic:m=6040,n=3706,nnz=900000 -k 10 -t 5 -l 0.05 \\
        --golden
    python -m cuda_recommender_tpu_torch.cli.train \\
        --dataset synthetic:m=6040,n=3706,nnz=900000 -k 10 -t 3 \\
        --backend hybrid --mask-dtype nan --panel-kernel --golden
    python -m cuda_recommender_tpu_torch.cli.train ds_dir -k 10 -t 3 -ALS \\
        --save-model model
    python -m cuda_recommender_tpu_torch.cli.train \\
        --dataset synthetic:m=6040,n=3706,nnz=900000 -k 10 -t 4 \\
        --backend ell --checkpoint-dir ck --checkpoint-every 2 [--resume]

On a CUDA device the run ends with one line of kernel launch counts
(``[info] kernel launches: {...}``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..core.config import Backend, Config, Solver
from ..core.metrics_log import MetricsLog
from ..core.trainer import check_supported, train
from ..data import binfmt, datasets


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.cli.train",
        description="CCD++/ALS matrix-factorization trainer "
                    "(PyTorch + CUDA)")
    # reference knobs (src/pmf.h:26-42 defaults)
    p.add_argument("-k", type=int, default=10, help="rank (default 10)")
    p.add_argument("-n", type=int, default=4, dest="threads",
                   help="threads (reference parity; sets nothing here)")
    p.add_argument("-l", type=float, default=0.1, dest="lambda_",
                   help="regularization lambda (default 0.1)")
    p.add_argument("-t", type=int, default=5, dest="maxiter",
                   help="outer iterations (default 5)")
    p.add_argument("-T", type=int, default=1, dest="maxinneriter",
                   help="inner iterations (default 1)")
    p.add_argument("-e", type=float, default=1e-3, dest="eps",
                   help="epsilon; inert like the reference unless "
                        "--early-stop is given")
    p.add_argument("--early-stop", action="store_true", dest="early_stop",
                   help="stop once an outer iteration improves test RMSE by "
                        "less than -e relative")
    p.add_argument("-p", type=int, default=0, dest="do_predict",
                   help="save the model and write predictions of the test "
                        "ratings to ./output after training")
    p.add_argument("-q", type=int, default=0, dest="verbose")
    p.add_argument("-N", type=int, default=0, dest="do_nmf",
                   help="nonnegative MF: clamp CCD++ rank-one updates at 0 "
                        "(libpmf semantics)")
    p.add_argument("-ALS", action="store_true", dest="als",
                   help="use ALS instead of CCD++")
    p.add_argument("-OMP", "--golden", action="store_true", dest="golden",
                   help="also run the golden NumPy backend and cross-validate")
    p.add_argument("-CUDA", action="store_true",
                   help="accepted for reference-script compat (the compiled "
                        "backend runs by default)")
    p.add_argument("-nBlocks", type=int, default=32,
                   help="accepted for reference-script compat (each kernel "
                        "picks its own launch geometry)")
    p.add_argument("-nThreadsPerBlock", type=int, default=256,
                   help="accepted for reference-script compat")
    p.add_argument("--backend", default="auto",
                   choices=[b.value for b in Backend],
                   help="CCD++: 'dense' (AUTO's choice for m*n <= "
                        "Config.dense_max_cells), 'pallas' (dense with a "
                        "bf16 mask), 'hybrid' (AUTO's choice above), 'ell' "
                        "(AUTO's choice where no panel row fits the cell "
                        "budget) or 'ref'. ALS: 'ell' (any request but "
                        "'ref' resolves to it) or 'ref'")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard over N ranks (one process a GPU, under "
                        "torchrun; WORLD_SIZE must be N)")
    p.add_argument("--mesh2d", default=None, metavar="AxB",
                   help="2-D (users x items) mesh of A*B ranks for the "
                        "dense backend")
    p.add_argument("--dist-backend", default=None, dest="dist_backend",
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend of a mesh (default: "
                        "nccl on cuda, gloo on cpu)")
    p.add_argument("--defer-group", type=int, default=None, metavar="G",
                   dest="defer_group",
                   help="hybrid ELL-tail rank-deferral group G: the "
                        "tail's residual is updated once every G ranks "
                        "(0 disables; single-device only)")
    p.add_argument("--fused-iters", type=int, default=1, dest="fused_iters",
                   help="outer iterations enqueued before the loop waits "
                        "for their RMSE readbacks")
    p.add_argument("--phase-timing", action="store_true", dest="phase_timing",
                   help="CCD++ only: fence and time each rank's "
                        "add-back, sweeps and subtract apart (rank_time / "
                        "update_time split; slower than the default)")
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
    p.add_argument("data_dir", nargs="?", default=None,
                   help="dataset directory (meta_modified_all or meta)")
    p.add_argument("--dataset", default=None,
                   help="synthetic:m=...,n=...,nnz=...[,seed=...] generator")
    p.add_argument("--save-model", default=None, metavar="PATH",
                   help="write trained factors (reference save_mat_t format)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write checkpoints (npz + manifest.json) here")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N outer iterations (0: never)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--metrics-file", default=None, help="JSONL metrics sink")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default) or cpu")
    return p


def build_config(args) -> Config:
    """The ``Config`` of parsed arguments, field for field as the JAX
    package's CLI builds it (the overrides go through ``Config``'s
    validation here)."""
    overrides = {}
    if args.hybrid_cells is not None:
        overrides["hybrid_dense_cells"] = int(args.hybrid_cells)
    if args.panel_widths is not None:
        overrides["hybrid_panel_widths"] = (
            "auto" if args.panel_widths == "auto" else
            tuple(int(w) for w in args.panel_widths.split(",") if w))
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
    if args.defer_group is not None:
        overrides["hybrid_defer_group"] = int(args.defer_group)
    return Config(
        solver=Solver.ALS if args.als else Solver.CCD,
        k=args.k, maxiter=args.maxiter, maxinneriter=args.maxinneriter,
        lambda_=args.lambda_, eps=args.eps, do_predict=bool(args.do_predict),
        verbose=bool(args.verbose), do_nmf=bool(args.do_nmf),
        threads=args.threads, backend=Backend(args.backend),
        golden=args.golden, seed=args.seed, early_stop=args.early_stop,
        residual_dtype=args.residual_dtype, data_dir=args.data_dir,
        mask_dtype=args.mask_dtype, fused_outer_iters=args.fused_iters,
        phase_timing=args.phase_timing,
        hybrid_panel_kernel=args.panel_kernel,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        metrics_file=args.metrics_file, **overrides)


def load_data(args):
    """(R, T) from ``--dataset`` or the data directory's manifest."""
    if args.dataset:
        return datasets.synthetic_from_spec(args.dataset)
    if not args.data_dir:
        raise SystemExit("need a data_dir or --dataset spec")
    if os.path.exists(os.path.join(args.data_dir, "meta_modified_all")):
        return binfmt.load_binary_dataset(args.data_dir)
    if os.path.exists(os.path.join(args.data_dir, "meta")):
        return binfmt.load_meta_text_dataset(args.data_dir)
    raise SystemExit(f"no meta_modified_all or meta manifest in {args.data_dir}")


def make_cli_mesh(args):
    """The mesh ``--mesh`` / ``--mesh2d`` ask for, over the initialized
    process group, or None."""
    from ..parallel.mesh import make_mesh, make_mesh_2d
    if args.mesh2d:
        a, b = (int(x) for x in args.mesh2d.lower().split("x"))
        return make_mesh_2d((a, b))
    return make_mesh(args.mesh) if args.mesh else None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    from ..parallel import multihost
    # a mesh's process group, from the launcher's environment; closed here
    # if opened here
    opened = bool(args.mesh or args.mesh2d) and multihost.initialize(
        args.device, backend=args.dist_backend)
    try:
        return _main(args, cfg, make_cli_mesh(args))
    finally:
        if opened:
            multihost.shutdown()


def _main(args, cfg: Config, mesh) -> int:
    root = mesh is None or mesh.get_rank() == 0
    R, T = load_data(args)
    if root:
        print(f"[info] loaded {R.rows} x {R.cols}, nnz={R.nnz}, "
              f"test nnz={T.nnz}", flush=True)
    if mesh is not None and cfg.hybrid_defer_group > 0:
        # the sharded hybrid never reads hybrid_defer_group: fail loud
        # instead of running the undeferred schedule (the JAX CLI's words)
        raise SystemExit("--defer-group is single-device-only: the sharded "
                         "hybrid path does not implement rank deferral "
                         "(pass --defer-group 0 or drop --mesh/--mesh2d)")
    check_supported(cfg, cfg.resolve_backend(R.rows, R.cols), mesh)
    log = MetricsLog(cfg.metrics_file if root else None, echo=root)
    try:
        result = train(cfg, R, T, device=args.device, log=log,
                       resume_from_checkpoint=args.resume,
                       **({} if mesh is None else {"mesh": mesh}))
        if root and (args.save_model or cfg.do_predict):
            path = args.save_model or "model"
            binfmt.save_model(path, result.W, result.H,
                              entity_major=result.entity_major)
            print(f"[info] model saved to {path}", flush=True)
            if cfg.do_predict:
                from ..serve.scoring import predict_pairs
                pred = predict_pairs(result.W, result.H, T.row_idx,
                                     T.col_idx,
                                     entity_major=result.entity_major,
                                     device=args.device)
                with open("output", "w") as f:
                    for v in pred:
                        f.write("%f\n" % v)
                print("[info] predictions written to ./output", flush=True)
    finally:
        log.close()
    if args.device.startswith("cuda") and root:
        from ..ops.launches import launch_counts
        print("[info] kernel launches: " + json.dumps(launch_counts()),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
