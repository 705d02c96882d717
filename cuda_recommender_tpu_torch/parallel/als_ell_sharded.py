"""ALS ELL backend, sharded over the ranks of a 1-D mesh.

The port of ``cuda_recommender_tpu/parallel/als_ell_sharded.py``. Each rank
owns a contiguous slot block of both factor tables and the matching ELL
bucket rows (round-robin, degree-balanced, data/ell.py). One ALS
half-iteration all-gathers the OPPOSITE side's factor table
((n_slots, k) floats, the only communication), then assembles the grams
of the rank's buckets with ``torch.bmm`` and solves them with K5, the
batched Gauss-Jordan kernel (ops/gj_kernels.py), on the rank's own slots:
the single-device step (solvers/als_ell.py) on the rank's shard of the
layout. Gauss-Seidel across sides is kept: the H update gathers the NEW W
(reference src/ALS.cpp:98-219).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import synchronize
from ..core.metrics_log import MetricsLog
from ..data.ell import build_ell_pair
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..solvers.als_ell import (k5_launches_per_iter, make_als_outer_step,
                               side_tensors)
from ..solvers.als_state import (als_payload_block, als_state_from_numpy,
                                 als_state_to_numpy, slot_payload)
from ..solvers.pipeline import pipelined_loop
from ..solvers.reference import IterStats
from .ccd_ell_sharded import local_pair
from .collectives import all_gather_rows, gather_arrays
from .mesh import ell_shardings
from .multihost import rank_device


def als_ell_train_sharded(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                          T: TestCOO, cfg: Config, mesh, *, device="cuda",
                          callback: Optional[Callable[[IterStats], None]] = None,
                          log: Optional[MetricsLog] = None,
                          ckpt_every: int = 0, ckpt_fn=None, resume=None,
                          ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """ALS over the ranks of ``mesh``; W0 (m, k), H0 (n, k) entity-major in
    and out, the same on every rank. Checkpoint payloads are the global
    slot-space factors (the JAX package's), on rank 0 (None elsewhere)."""
    lay = ell_shardings(mesh)
    # the JAX package's sharded step maps every precision but "highest" to
    # DEFAULT (its parallel/als_ell_sharded.py:40-41), so "high" runs one
    # bf16 pass here too
    precision = "highest" if cfg.als_precision == "highest" else "default"
    dev = rank_device(device)
    group_bytes = cfg.als_group_mb << 20
    ell = build_ell_pair(R, min_width=cfg.als_min_width,
                         num_shards=lay.num_shards)
    rows_g, cols_g = ell.rows_side, ell.cols_side
    loc = local_pair(ell, lay.shard)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
    payload = resume if resume is not None else slot_payload(ell, W0, H0)
    W, H = als_state_from_numpy(als_payload_block(payload, ell, lay.shard),
                                loc, dev)
    idx_r, vals_r = side_tensors(loc.rows_side, dev)
    idx_c, vals_c = side_tensors(loc.cols_side, dev)
    nnz_r = torch.as_tensor(loc.rows_side.slot_nnz, device=dev)
    nnz_c = torch.as_tensor(loc.cols_side.slot_nnz, device=dev)
    synchronize(dev)
    if log is not None:
        log.info(f"[info] als sharded over {lay.num_shards} ranks: "
                 f"{loc.rows_side.n_slots} + {loc.cols_side.n_slots} slots "
                 f"a rank; gram precision {precision}; K5 launches per "
                 f"iteration a rank {k5_launches_per_iter(loc, W0.shape[1], cfg.als_solver, group_bytes, precision)}")

    def gather(F):
        return all_gather_rows(F, lay.group)

    step = make_als_outer_step(loc, cfg.lambda_, solver=cfg.als_solver,
                               group_bytes=group_bytes, gather=gather,
                               precision=precision)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti = i64(rows_g.slot_of_entity[T.row_idx])
    tj = i64(cols_g.slot_of_entity[T.col_idx])
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)
    box = {"WH": (W, H)}

    def do_step():
        box["WH"] = step(idx_r, idx_c, vals_r, vals_c, *box["WH"], nnz_r,
                         nnz_c)
        return box["WH"][0]

    def get_payload():
        parts = gather_arrays(als_state_to_numpy(*box["WH"]), dev, lay.group)
        return None if parts is None else {
            key: np.concatenate(blocks) for key, blocks in parts.items()}

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters, do_step=do_step,
        do_rmse=lambda: calrmse_device(ti, tj, tv, *map(gather, box["WH"]),
                                       entity_major=True, chunk=chunk),
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    W, H = (gather(F).cpu().numpy() for F in box["WH"])
    return W[rows_g.slot_of_entity], H[cols_g.slot_of_entity], stats
