"""CCD++ ELL backend, sharded over the ranks of a 1-D mesh.

The port of ``cuda_recommender_tpu/parallel/ccd_ell_sharded.py``. Both ELL
orientations are built with ``num_shards = N``: every bucket's rows are
dealt round-robin across the ranks (degree-balanced) and padded
shard-uniform, and the global slot order is shard-major, so rank s holds
one contiguous slot block of each factor table (``mesh.ell_shardings``).
Per rank sweep:

  * the swept side's new vector is local to each rank's slot block;
  * the opposite side's vectors are all-gathered (``collectives.
    all_gather_rows``, JAX's ``all_gather(tiled=True)``): the stacked
    [u_pend, u_old] table of the add-back and [v_pend, v_old, v], 2
    gathers per rank and inner iteration;
  * the residual bucket tiles are updated locally, never communicated.

The per-rank body is the single-device step (solvers/ccd_ell.py) on the
rank's shard of the layout, with the all-gather as its table hook: plain
torch gathers, as the JAX package leaves this path to XLA (no Pallas
kernel on it). The RMSE and the result gather the factors; a checkpoint is
the JAX package's global payload, gathered to rank 0.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import synchronize
from ..core.metrics_log import MetricsLog
from ..data.ell import EllPair, build_ell_pair, shard_view
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..solvers.ccd_ell import make_ell_outer_step, side_tiles
from ..solvers.ell_state import (ell_payload_assemble, ell_payload_block,
                                 ell_state_from_numpy, ell_state_to_numpy,
                                 factors_to_slots)
from ..solvers.pipeline import pipelined_loop
from ..solvers.reference import IterStats
from .collectives import all_gather_rows, gather_arrays
from .mesh import ell_shardings
from .multihost import rank_device


def local_pair(ell: EllPair, shard: int) -> EllPair:
    """Rank ``shard``'s part of a shard-uniform pair: both sides'
    ``shard_view``."""
    return EllPair(rows_side=shard_view(ell.rows_side, shard),
                   cols_side=shard_view(ell.cols_side, shard),
                   n_rows=ell.n_rows, n_cols=ell.n_cols, nnz=ell.nnz)


def gather_factors(F: torch.Tensor, group) -> torch.Tensor:
    """The ranks' (k, slot block) factors as the global (k, n_slots)."""
    return all_gather_rows(F.T, group).T


def initial_payload(ell: EllPair, W0: np.ndarray) -> dict:
    """The global state at outer iteration 1 as a payload: the ratings in
    the value tiles, W0 in slot space, H zero (src/CCD.cpp:56-60), nothing
    pending."""
    rows, cols = ell.rows_side, ell.cols_side
    out = {"W": factors_to_slots(np.asarray(W0, np.float32), rows),
           "H": np.zeros((W0.shape[0], cols.n_slots), np.float32),
           "u_pend": np.zeros(rows.n_slots, np.float32),
           "v_pend": np.zeros(cols.n_slots, np.float32)}
    for key, side in (("vals_r", rows), ("vals_c", cols)):
        for i, b in enumerate(side.buckets):
            out[f"{key}_{i}"] = b.val
    return out


def ccd_ell_train_sharded(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                          T: TestCOO, cfg: Config, mesh, *, device="cuda",
                          callback: Optional[Callable[[IterStats], None]] = None,
                          log: Optional[MetricsLog] = None,
                          ckpt_every: int = 0, ckpt_fn=None, resume=None,
                          ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """CCD++ on the ELL backend over the ranks of ``mesh``, each rank on
    its device (``device``; ``cuda`` means ``cuda:{LOCAL_RANK}``). Every
    rank returns the same (W, H, stats) in the reference's rank-major
    entity order, numerically the single-device ELL backend's up to the
    all-gathers' exact copies (the per-slot sums do not cross ranks).
    ``ckpt_fn(oiter, payload)`` gets the global payload (the JAX package's
    keys and shapes) on rank 0 and None on the others; ``resume`` is such
    a payload plus its ``oiter``."""
    lay = ell_shardings(mesh)
    dev = rank_device(device)
    ell = build_ell_pair(R, min_width=cfg.ell_min_width,
                         num_shards=lay.num_shards)
    rows_g, cols_g = ell.rows_side, ell.cols_side
    loc = local_pair(ell, lay.shard)
    idx_r, idx_c = side_tiles(loc.rows_side, dev), side_tiles(loc.cols_side,
                                                              dev)
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        payload = resume
    else:
        payload = initial_payload(ell, W0)
    state = ell_state_from_numpy(ell_payload_block(payload, ell, lay.shard),
                                 loc, dev)
    del payload
    rnnz_r = torch.as_tensor(loc.rows_side.slot_nnz, device=dev)
    rnnz_c = torch.as_tensor(loc.cols_side.slot_nnz, device=dev)
    synchronize(dev)
    if log is not None:
        log.info(f"[info] ell sharded over {lay.num_shards} ranks: "
                 f"{loc.rows_side.n_slots} + {loc.cols_side.n_slots} slots "
                 f"a rank")

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti, tj = i64(rows_g.slot_of_entity[T.row_idx]), i64(
        cols_g.slot_of_entity[T.col_idx])
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)
    step = make_ell_outer_step(
        loc, idx_r, idx_c, rnnz_r, rnnz_c, cfg.lambda_, cfg.maxinneriter,
        nmf=cfg.do_nmf, gather=lambda x: all_gather_rows(x, lay.group))

    def do_rmse():
        return calrmse_device(ti, tj, tv, gather_factors(state.W, lay.group),
                              gather_factors(state.H, lay.group),
                              entity_major=False, chunk=chunk)

    def get_payload():
        parts = gather_arrays(ell_state_to_numpy(state), dev, lay.group)
        return None if parts is None else ell_payload_assemble(parts)

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters, do_step=lambda: step(state),
        do_rmse=do_rmse, callback=callback, ckpt_every=ckpt_every,
        ckpt_fn=ckpt_fn, get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    W = gather_factors(state.W, lay.group).cpu().numpy()
    H = gather_factors(state.H, lay.group).cpu().numpy()
    return W[:, rows_g.slot_of_entity], H[:, cols_g.slot_of_entity], stats
