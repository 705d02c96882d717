"""Panel-hybrid CCD++, sharded over the ranks of a 1-D mesh.

The port of ``cuda_recommender_tpu/parallel/ccd_hybrid_sharded.py``. Every
dense panel's rows are split into N equal per-rank blocks (the planner
N-aligns the panel boundaries: ``plan_hybrid(..., num_shards=N)``), and the
ELL remainder is built shard-uniform (data/ell.py), so all residual state
-- panel blocks and bucket value tiles -- is rank-local and never
communicated. The factor tables W (k, m) and H (k, n) are REPLICATED: each
rank computes partial per-entity sweep sums (g, h) from its panel blocks
and its ELL rows, and ONE all-reduce of the concatenated (g, h) per
half-sweep (the JAX package's one ``psum``) makes the new factor vector
identical on every rank: 2·k·T all-reduces per outer iteration.

The per-rank math is the single-device step (solvers/ccd_hybrid.py) on the
rank's part of the plan (``local_plan``), with the all-reduce as its
``reduce`` hook: per rank t, K1 (``panel_update_vsweep``; K3 on inner
iterations) on the rank's NaN panel blocks, or K4 and the masked sweeps
beside explicit masks, and the fused ELL pass on its tail rows; the
all-reduce; K2 (or ``masked_usweep``) and the tail; the second all-reduce.
The kernels take each local block as it is: a ragged last row block, a row
count that is not a multiple of 8 or 64.

Checkpoints carry the JAX package's global payload, gathered to rank 0:
with the panel kernel each rank's panel block is NaN-padded to its own
block shape (the JAX ``densify_panels(..., block_pad=True,
num_shards=N)`` layout), so a checkpoint of either package's sharded run
resumes in the other at the same N.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import synchronize
from ..core.metrics_log import MetricsLog
from ..data.ell import EllPair
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.densify import RESIDUAL_DTYPES
from ..solvers.ccd_hybrid import (HybridPlan, device_plan, hybrid_store_order,
                                  initial_state,
                                  make_hybrid_outer_step,
                                  make_hybrid_phase_fns, plan_hybrid)
from ..solvers.hybrid_state import (REPLICATED, hybrid_payload_block,
                                    hybrid_state_from_numpy,
                                    hybrid_state_to_numpy,
                                    padded_panel_shape)
from ..solvers.phase_loop import phased_ccd_loop, rank_rows, refuse_pending
from ..solvers.pipeline import pipelined_loop
from ..solvers.reference import IterStats
from .ccd_ell_sharded import local_pair
from .collectives import all_reduce_pair, gather_arrays
from .mesh import ell_shardings
from .multihost import rank_device


def local_map(slot_of_pos: np.ndarray, slots_per_shard: int,
              shard: int) -> np.ndarray:
    """Entity -> its slot in rank ``shard``'s slot block, or the block's
    zero slot (``slots_per_shard``) where another rank owns the entity
    (the JAX trainer's ``local_map``, one row of it)."""
    slot = np.asarray(slot_of_pos, np.int64)
    return np.where(slot // slots_per_shard == shard,
                    slot % slots_per_shard, slots_per_shard)


def local_plan(plan: HybridPlan, shard: int, num_shards: int) -> HybridPlan:
    """Rank ``shard``'s part of an N-aligned plan (``plan_hybrid(...,
    materialize_dense=False, num_shards=N)``): each panel's rows
    [r0 + s·h, r0 + (s+1)·h), h = (r1 - r0) / N, with that block's COO (row
    indices local to the block); the tail's shard (``shard_view``) with
    its slot <-> entity maps. With N = 1 the plan itself."""
    if num_shards == 1:
        return plan
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    panels, coo = [], []
    for (r0, r1, w), (lr, lc, lv) in zip(plan.panels, plan.panel_coo or ()):
        if (r1 - r0) % num_shards:
            raise ValueError(f"panel rows [{r0}, {r1}) are not "
                             f"{num_shards}-aligned: plan with num_shards")
        h = (r1 - r0) // num_shards
        lo = shard * h
        keep = (lr >= lo) & (lr < lo + h)
        panels.append((r0 + lo, r0 + lo + h, w))
        coo.append(((lr[keep] - lo).astype(lr.dtype), lc[keep], lv[keep]))
    sr, sc = rows.slots_per_shard, cols.slots_per_shard
    return dataclasses.replace(
        plan, panels=tuple(panels), panel_coo=tuple(coo) or None,
        ell=local_pair(plan.ell, shard),
        upos_of_slot_safe=plan.upos_of_slot_safe[shard * sr:(shard + 1) * sr],
        ipos_of_slot_safe=plan.ipos_of_slot_safe[shard * sc:(shard + 1) * sc],
        slot_of_upos=local_map(plan.slot_of_upos, sr, shard),
        slot_of_ipos=local_map(plan.slot_of_ipos, sc, shard))


def local_plan_from_shards(mf, shards, csr_ptr: np.ndarray,
                           csc_ptr: np.ndarray, shard: int,
                           num_shards: int) -> HybridPlan:
    """Rank ``shard``'s part of the plan (as ``local_plan`` gives it) built
    from what the rank range-read (``data/shard_loader.py::
    load_local_hybrid_shards`` with ``shard_ids=[shard]``: its panel row
    blocks and its shard of the tail) and the layout manifest ``mf``,
    without the rating matrix: the multi-host path, where no rank holds
    the full nnz. The degrees come from the two ptr arrays."""
    m, n = mf.m, mf.n
    user_pos = np.empty(m, np.int64)
    user_pos[mf.user_order] = np.arange(m)
    item_pos = np.empty(n, np.int64)
    item_pos[mf.item_order] = np.arange(n)
    rows, cols = shards.rows_side, shards.cols_side

    def filled(side, blocks):
        bks = tuple(dataclasses.replace(b, idx=blk[0][0], val=blk[0][1])
                    for b, blk in zip(side.buckets, blocks))
        sl = slice(shard * side.slots_per_shard,
                   (shard + 1) * side.slots_per_shard)
        return dataclasses.replace(side, num_shards=1, buckets=bks,
                                   entity_of_slot=side.entity_of_slot[sl],
                                   slot_nnz=side.slot_nnz[sl])

    panels, coo = [], []
    for (r0, r1, w), blocks in zip(mf.panels, shards.panel_blocks):
        A, Mk = blocks[0]
        h = (r1 - r0) // num_shards
        lr, lc = np.nonzero(Mk)
        panels.append((r0 + shard * h, r0 + (shard + 1) * h, w))
        coo.append((lr.astype(np.int32), lc.astype(np.int32),
                    A[lr, lc].astype(np.float32)))
    sr, sc = rows.slots_per_shard, cols.slots_per_shard
    upos = np.where(rows.entity_of_slot < 0, m, rows.entity_of_slot)
    ipos = np.where(cols.entity_of_slot < 0, n, cols.entity_of_slot)
    return HybridPlan(
        user_order=mf.user_order, item_order=mf.item_order,
        user_pos=user_pos, item_pos=item_pos, panels=tuple(panels),
        ell=EllPair(rows_side=filled(rows, shards.rows_blocks),
                    cols_side=filled(cols, shards.cols_blocks),
                    n_rows=m, n_cols=n, nnz=int(csr_ptr[-1])),
        nnz_light=int(mf.light_deg_row.sum()), Rd=(), Md=(),
        row_nnz=np.diff(csr_ptr)[mf.user_order].astype(np.float32),
        col_nnz=np.diff(csc_ptr)[mf.item_order].astype(np.float32),
        slot_of_upos=local_map(rows.slot_of_entity, sr, shard),
        slot_of_ipos=local_map(cols.slot_of_entity, sc, shard),
        upos_of_slot_safe=upos[shard * sr:(shard + 1) * sr].astype(np.int32),
        ipos_of_slot_safe=ipos[shard * sc:(shard + 1) * sc].astype(np.int32),
        panel_coo=tuple(coo) or None)


def make_sharded_hybrid_step(loc: HybridPlan, dplan, mesh, lam: float,
                             maxinneriter: int, *, order: str,
                             nmf: bool = False):
    """One outer iteration of the rank's part ``loc`` of the plan, with one
    all-reduce of (g, h) over the mesh per half-sweep; updates the rank's
    ``HybridState`` in place. ``order``: the panel updates' store order
    (``solvers/ccd_hybrid.py::hybrid_store_order``: delta-first at fp8
    without the panel kernel, as the JAX sharded step's XLA update
    rounds). The sharded step
    has no deferred tail (the JAX package's reads no defer group)."""
    group = ell_shardings(mesh).group
    return make_hybrid_outer_step(
        loc, dplan, lam, maxinneriter, nmf=nmf, order=order,
        reduce=lambda g, h: all_reduce_pair(g, h, group))


def make_sharded_hybrid_phase_fns(loc: HybridPlan, dplan, mesh, lam: float,
                                  maxinneriter: int = 1, *,
                                  nmf: bool = False):
    """Phase-split (addback, sweeps, subtract) functions of the SHARDED
    hybrid (the JAX package's ``make_sharded_hybrid_phase_fns``): the
    single-device phase functions on the rank's part of the plan, the
    sweeps with one all-reduce per half-sweep; each phase can be fenced
    and timed (solvers/phase_loop.py), so the iteration line's
    rank_time / update_time split is measured on the mesh."""
    group = ell_shardings(mesh).group
    return make_hybrid_phase_fns(
        loc, dplan, lam, maxinneriter, nmf=nmf,
        reduce=lambda g, h: all_reduce_pair(g, h, group))


def ccd_hybrid_train_sharded(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                             T: TestCOO, cfg: Config, mesh, *, device="cuda",
                             callback: Optional[Callable] = None,
                             log: Optional[MetricsLog] = None,
                             run: Optional[dict] = None,
                             ckpt_every: int = 0, ckpt_fn=None, resume=None,
                             rank_callback=None,
                             ) -> tuple[np.ndarray, np.ndarray,
                                        list[IterStats]]:
    """Panel-hybrid CCD++ over the ranks of ``mesh``; every rank returns
    the same (W, H, stats) in the reference's rank-major ORIGINAL entity
    order. ``run``, when given, gets ``transposed`` (False: the sharded
    hybrid plans the user-axis stair), ``plan`` (the global plan),
    ``plan_s`` and ``setup_s``. ``ckpt_fn(oiter, payload)`` gets the
    global payload on rank 0 and None on the others. With
    ``cfg.phase_timing`` the sharded phase functions run, fenced and timed
    apart (``rank_callback(oiter, t, dt, rmse)`` per rank)."""
    if cfg.phase_timing:
        refuse_pending(resume)
    lay = ell_shardings(mesh)
    N, shard = lay.num_shards, lay.shard
    dev = rank_device(device)
    t0 = time.perf_counter()
    plan = plan_hybrid(R, cfg, materialize_dense=False, num_shards=N)
    loc = local_plan(plan, shard, N)
    t1 = time.perf_counter()
    dplan = device_plan(loc, dev)
    rdt = RESIDUAL_DTYPES[cfg.residual_dtype]
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        state = hybrid_state_from_numpy(
            hybrid_payload_block(resume, plan, shard, N), loc, dev,
            cfg.mask_dtype, dtype=rdt)
    else:
        state = initial_state(loc, W0, rdt, dev, cfg.mask_dtype)
    synchronize(dev)
    t2 = time.perf_counter()
    if run is not None:
        run.update(transposed=False, plan=plan, plan_s=t1 - t0,
                   setup_s=t2 - t1)
    if log is not None:
        cells = sum((r1 - r0) * w for r0, r1, w in plan.panels)
        log.info(f"[info] hybrid plan sharded over {N} ranks: "
                 f"{len(plan.panels)} panels {list(plan.panels)}, {cells} "
                 f"panel cells, tail nnz {plan.nnz_light} of {R.nnz}; "
                 f"plan {t1 - t0:.3f} s, device set-up {t2 - t1:.3f} s")
        log.event("hybrid_plan", panels=[list(p) for p in plan.panels],
                  mask_dtype=cfg.mask_dtype, panel_cells=cells, nnz=R.nnz,
                  nnz_light=plan.nnz_light, transposed=False,
                  num_shards=N, plan_s=t1 - t0, setup_s=t2 - t1)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti_np, tj_np = plan.user_pos[T.row_idx], plan.item_pos[T.col_idx]
    ti, tj = i64(ti_np), i64(tj_np)
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)
    shapes = ([padded_panel_shape(r1 - r0, w) for r0, r1, w in loc.panels]
              if cfg.hybrid_panel_kernel else None)

    def get_payload():
        local = hybrid_state_to_numpy(state, panel_shapes=shapes)
        parts = gather_arrays({key: x for key, x in local.items()
                               if key not in REPLICATED}, dev, lay.group)
        if parts is None:
            return None
        out = {key: local[key] for key in REPLICATED}
        out.update((key, np.concatenate(blocks))
                   for key, blocks in parts.items())
        return out

    common = dict(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        do_rmse=lambda: calrmse_device(ti, tj, tv, state.W, state.H,
                                       entity_major=False, chunk=chunk),
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=get_payload,
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    lam, inner, nmf = cfg.lambda_, cfg.maxinneriter, cfg.do_nmf
    if cfg.phase_timing:
        ab, sw, sub = make_sharded_hybrid_phase_fns(loc, dplan, mesh, lam,
                                                    inner, nmf=nmf)
        stats = phased_ccd_loop(
            k=W0.shape[0], device=dev,
            addback=lambda t: ab(state, t), sweeps=lambda t: sw(state, t),
            subtract=lambda t: sub(state, t),
            get_rank_rows=rank_rows(state),
            ti=ti_np, tj=tj_np, tv=np.asarray(T.val),
            rank_callback=rank_callback, **common)
    else:
        step = make_sharded_hybrid_step(
            loc, dplan, mesh, lam, inner, nmf=nmf,
            order=hybrid_store_order(cfg))
        stats = pipelined_loop(fuse=cfg.fused_outer_iters,
                               do_step=lambda: step(state), **common)
    W = state.W.cpu().numpy()[:, plan.user_pos]
    H = state.H.cpu().numpy()[:, plan.item_pos]
    return W, H, stats
