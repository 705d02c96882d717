"""Run a list of sharded cases on every rank, one process group for all.

    torchrun --standalone --nproc-per-node 4 \\
        -m cuda_recommender_tpu_torch.parallel.run_cases cases.json out \\
        --device cpu

``cases.json`` is a list of cases, run in order on every rank; each names
its mesh (``"mesh": N`` or ``[a, b]``) and its kind:

* ``solve``: the sharded trainer of the case's ``cfg`` (``core/trainer.py
  ::solve`` with the mesh) on ``datasets.synthetic(**data)``, from
  ``init_factors_np(k, m, n, seed=0)`` as the trainer seeds it;
* ``train``: ``train()`` with the mesh (checkpoints, ``resume``);
* ``phase``: the sharded hybrid with ``phase_timing``, its phase
  functions fenced and timed;
* ``topk``: ``topk_mips_sharded`` over the factors of an npz;
* ``load_hybrid``: range-read loading (``data/shard_loader.py``) of the
  rank's panel blocks and tail shard from a binary dataset and a hybrid
  manifest, asserting that the rank read exactly its fair share, then the
  sharded hybrid step ``cfg.maxiter`` times.

Rank 0 writes ``out/<name>.npz`` (factors, per-iteration RMSE and times,
the collective counts and the bytes it passed to them); every rank writes
its factors to ``out/<name>.rank<r>.npz`` where they are the result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch.distributed as dist

from ..core.config import Config, Solver
from ..core.init import init_factors_np
from ..core.metrics_log import MetricsLog
from ..core.trainer import solve, train
from ..data import datasets
from . import collectives, multihost
from .mesh import make_mesh, make_mesh_2d


def _mesh(spec):
    return make_mesh_2d(tuple(spec)) if isinstance(spec, list) \
        else make_mesh(spec)


def _stats(stats) -> dict:
    return {"rmse": [s.rmse for s in stats],
            "rank_time": [s.rank_time for s in stats],
            "update_time": [s.update_time for s in stats]}


def run_case(case: dict, device) -> dict:
    mesh = _mesh(case["mesh"])
    kind = case["kind"]
    collectives.reset_collective_counts()
    if kind == "topk":
        from ..serve.retrieval_sharded import topk_mips_sharded
        z = np.load(case["factors"])
        excl = {int(u): np.asarray(v) for u, v in
                case.get("exclude", {}).items()} or None
        s, i = topk_mips_sharded(z["W"], z["H"], case["users"], mesh,
                                 topk=case["topk"], chunk=case["chunk"],
                                 exclude=excl, int8=case.get("int8", False),
                                 device=device)
        return dict(s=s, i=i)
    if kind == "load_hybrid":
        return _load_hybrid(case, mesh, device)
    R, T = datasets.synthetic(**case["data"])
    cfg = Config(**case["cfg"])
    if kind == "train":
        res = train(cfg, R, T, device=device, mesh=mesh, log=MetricsLog(None, echo=False),
                    resume_from_checkpoint=case.get("resume", False))
        return dict(W=res.W, H=res.H, **_stats(res.stats))
    backend = cfg.resolve_backend(R.rows, R.cols)
    W0, H0 = init_factors_np(cfg.k, R.rows, R.cols, seed=cfg.seed,
                             entity_major=cfg.solver == Solver.ALS)
    if kind == "phase":
        from .ccd_hybrid_sharded import ccd_hybrid_train_sharded
        W, H, stats = ccd_hybrid_train_sharded(R, W0, H0, T, cfg, mesh,
                                               device=device)
    else:
        W, H, stats = solve(cfg, backend, R, W0, H0, T, device=device,
                            mesh=mesh)
    return dict(W=W, H=H, **_stats(stats))


def _load_hybrid(case: dict, mesh, device) -> dict:
    """The range-read hybrid: no rank holds the rating matrix."""
    from ..data.shard_loader import (load_header, load_hybrid_manifest,
                                     load_local_hybrid_shards, load_ptrs)
    from ..ops.densify import RESIDUAL_DTYPES
    from ..solvers.ccd_hybrid import (device_plan, hybrid_store_order,
                                      initial_state)
    from .ccd_hybrid_sharded import (local_plan_from_shards,
                                     make_sharded_hybrid_step)
    from .multihost import rank_device

    cfg = Config(**case["cfg"])
    N, shard = mesh.size(), mesh.get_rank()
    mf = load_hybrid_manifest(case["manifest"])
    shards = load_local_hybrid_shards(case["data_dir"], mf, N, [shard],
                                      ell_min_width=cfg.ell_min_width)
    if shards.nnz_read != shards.expected_nnz_read:
        raise AssertionError(f"rank {shard} read {shards.nnz_read}, its "
                             f"share is {shards.expected_nnz_read}")
    csr_ptr, csc_ptr = load_ptrs(case["data_dir"],
                                 load_header(case["data_dir"]))
    loc = local_plan_from_shards(mf, shards, csr_ptr, csc_ptr, shard, N)
    dev = rank_device(device)
    W0, _ = init_factors_np(cfg.k, mf.m, mf.n, seed=cfg.seed)
    rdt = RESIDUAL_DTYPES[cfg.residual_dtype]
    state = initial_state(loc, W0, rdt, dev, cfg.mask_dtype)
    step = make_sharded_hybrid_step(
        loc, device_plan(loc, dev), mesh, cfg.lambda_, cfg.maxinneriter,
        nmf=cfg.do_nmf, order=hybrid_store_order(cfg))
    for _ in range(cfg.maxiter):
        step(state)
    return dict(W=state.W.cpu().numpy(), H=state.H.cpu().numpy(),
                nnz_read=shards.nnz_read, nnz=int(csr_ptr[-1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cuda_recommender_tpu_torch.parallel.run_cases")
    p.add_argument("cases")
    p.add_argument("out")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    with open(args.cases) as f:
        cases = json.load(f)
    if not multihost.initialize(args.device):
        raise SystemExit("run_cases needs a launcher's environment "
                         "(torchrun or parallel.launch)")
    try:
        rank = dist.get_rank()
        for case in cases:
            res = run_case(case, args.device)
            res["collectives"] = json.dumps(collectives.collective_counts())
            res["collective_bytes"] = json.dumps(
                collectives.collective_bytes())
            if rank == 0:
                np.savez(os.path.join(args.out, case["name"] + ".npz"),
                         **res)
            if "W" in res:
                np.savez(os.path.join(args.out,
                                      f"{case['name']}.rank{rank}.npz"),
                         W=res["W"], H=res["H"])
            print(f"[rank {rank}] {case['name']} done", flush=True)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
