"""CCD++ — panel-hybrid backend (the large-matrix path), in PyTorch.

The port of ``cuda_recommender_tpu/solvers/ccd_hybrid.py`` for one GPU. The
matrix is split so the cells that carry the mass are dense:

  * users AND items are sorted by degree; real rating matrices are doubly
    power-law, so the nnz mass concentrates in the top-left corner;
  * a small stair of **dense panels** covers that corner — panel 1 = top
    users x ALL items, panel 2 = next users x top-w2 items, ... — each a
    residual block whose unobserved cells either hold a NaN sentinel
    (``mask_dtype="nan"``; the panel kernels K1-K3, ops/panel_kernels.py)
    or hold 0 beside an explicit {0,1} mask of bfloat16 or int8 (K4 and the
    masked sweeps, ops/ccd_kernels.py);
  * the sparse remainder keeps the degree-bucketed padded-ELL layout
    (data/ell.py), swept by plain torch gathers (ops/ell_ops.py).

Factors live in degree-sorted entity order — W (k, m), H (k, n) — so every
panel touches a contiguous slice and the ELL bucket ``idx`` arrays
reference entity positions directly (``index_space="entity"``). Per entity
the sweep sums combine across parts before the division (RankOneUpdate,
reference src/CCD.cpp:6-16):

    new_j = (sum_p g_panel_p + g_ell) / (lambda*nnz_j + sum_p h_p + h_ell)

with nnz_j the entity's TOTAL degree (src/CCD.cpp:112,120).

Host half (``HybridPlan``, ``plan_hybrid`` and its search helpers): copied
from the JAX package with its semantics unchanged, so both packages build
bit-identical plans. Device half: ``densify_panels``, the outer step and
``ccd_hybrid_train`` — the JAX package's schedule for both panel layouts,
with its rank-deferral option (``hybrid_defer_group``). Every part defers
the subtract of a rank's new outer product to the next rank through the
shared (u_pend, v_pend) state, so each panel costs one read-modify-write
pass (K1, or K4 with a mask) and one read pass (K2, or ``masked_usweep``)
per rank, and each ELL side one gather pass (with G > 0 the tail's values
stay frozen for G ranks and one flush a group applies the deferred
deltas). ``hybrid_panel_kernel=False`` with NaN panels runs the same
kernels. At an f32 residual the JAX package's einsum panel path
(ccd_hybrid.py:580-586, 615-626, 654-662, 715-723) is the same math. At a
bf16 residual it is not: the einsum path rounds the delta (or delta·mask)
to bf16 before the add, rounds the sum again and sweeps the stored value,
while the port rounds once and, in a masked panel, K4 sweeps the f32 sum
before that rounding (the JAX pallas schedule; K1 sweeps the stored
value, as the JAX panel kernel does), one bf16 ULP apart. At an fp8
residual the two orders differ in about a quarter of the cells, so there
K1 and K4 store in the JAX path's own order (``ops/densify.py::
store_order``): delta-first for explicit masks and for NaN panels without
the panel kernel (the einsum path), once with it (the Pallas kernel).

Phase timing (``cfg.phase_timing``, ``make_hybrid_phase_fns``) runs the
reference's plain order per rank instead — add-back, sweeps, immediate
subtract, each fenced (solvers/phase_loop.py): the sweeps are K3 and K2
(or ``masked_vsweep`` and ``masked_usweep``) and the tail's
``sweep_partials``; the update phases are plain torch, as XLA computes
them in the JAX package (ccd_dense.py::rank1_update, ops/ell_ops.py::
residual_update). Checkpoints carry the whole state (solvers/
hybrid_state.py), panels block-padded as the JAX panel-kernel path stores
them.

Semantics preserved (SURVEY.md §7): H zeroed at entry (src/CCD.cpp:56-60);
lambda*nnz regularization with total degrees; v-sweep before u-sweep per
inner iteration (src/CCD.cpp:110-121); empty entity -> 0 factor (via the
full-denominator guard); rank-major factor layout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device, synchronize
from ..core.metrics_log import MetricsLog
from ..data.ell import EllPair, build_ell_pair
from ..native.groupsort import key_count, perm_gather, stable_perm
from ..data.sparse import RatingMatrix, TestCOO, from_coo, make_test
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.ccd_kernels import fused_update_vsweep, masked_usweep, masked_vsweep
from ..ops.densify import (RESIDUAL_DTYPES, densify_coo_mask, densify_coo_nan,
                           store_order)
from ..ops.ell_ops import (deferred_flush, deferred_sweep, extend_zero,
                           fused_remap_combine, fused_sweep,
                           fused_update_sweep, residual_update, stacked_remap,
                           sweep_partials)
from ..ops.panel_kernels import (panel_update_vsweep, panel_usweep,
                                 panel_vsweep)
from ..utils.timing import span
from .ccd_dense import _half_sweep, rank1_update
from .hybrid_state import (HybridState, hybrid_state_from_numpy,
                           hybrid_state_to_numpy, padded_panel_shape)
from .phase_loop import phased_ccd_loop, rank_rows, refuse_pending
from .pipeline import pipelined_loop
from .reference import IterStats


@dataclasses.dataclass(frozen=True)
class HybridPlan:
    """Host-side panel plan over the degree-sorted matrix."""

    user_order: np.ndarray     # (m,) original user ids, degree-sorted
    item_order: np.ndarray     # (n,) original item ids, degree-sorted
    user_pos: np.ndarray       # (m,) original id -> sorted position
    item_pos: np.ndarray       # (n,)
    #: dense panels as (r0, r1, width): sorted-user rows [r0, r1) x sorted
    #: items [0, width). r ranges are contiguous from 0, widths decreasing.
    panels: tuple[tuple[int, int, int], ...]
    ell: EllPair               # sparse remainder (m x n, sorted coords,
    #                            entity-indexed buckets)
    nnz_light: int
    Rd: tuple                  # per panel (rows, w) f32 residual init
    Md: tuple                  # per panel (rows, w) f32 {0,1} mask
    row_nnz: np.ndarray        # (m,) TOTAL user degrees, sorted order
    col_nnz: np.ndarray        # (n,) TOTAL item degrees, sorted order
    # ELL slot <-> entity maps (entities = sorted positions)
    slot_of_upos: np.ndarray   # (m,)
    slot_of_ipos: np.ndarray   # (n,)
    upos_of_slot_safe: np.ndarray  # (n_row_slots,) padding -> m
    ipos_of_slot_safe: np.ndarray  # (n_col_slots,) padding -> n
    #: with ``materialize_dense=False``: per panel (local_row, col, val) COO
    #: for device-side scatter (a host-built Netflix panel is GBs of RAM and
    #: a multi-GB host->device ship; the COO is ~nnz-sized)
    panel_coo: Optional[tuple] = None


def _candidate_boundaries(m: int, align: int = 8, npts: int = 129,
                          include_full: bool = False) -> np.ndarray:
    cand = np.unique((np.linspace(0, m, npts) / align).round()
                     .astype(np.int64) * align)
    cand = np.minimum(cand, (m // align) * align)
    if include_full:
        # the exact row count as a candidate (kernel blocks clamp+pad, so
        # alignment is only a sharding constraint): a budget >= m*n then
        # yields ONE full panel and no ELL tail at all — the dense case as
        # a degenerate hybrid plan.
        cand = np.unique(np.append(cand, m))
    return cand


def _search_boundaries(prefixes, widths, cand, budget: int,
                       passes: int = 6) -> list[int]:
    """Maximize covered nnz over non-decreasing boundaries r_1 <= ... <= r_W
    (panel p spans users [r_{p-1}, r_p) at width w_p) under the cell budget
    Σ (r_p - r_{p-1})·w_p, by coordinate ascent: optimize one boundary at a
    time (vectorized over candidates) holding the others fixed, alternating
    sweep direction. O(passes · W · |cand|) — a joint grid would be
    |cand|^W, which hangs for more than ~3 panel widths."""
    W = len(widths)
    r = [0] * W

    def cells(rr):
        tot, prev = 0, 0
        for b, w in zip(rr, widths):
            tot += (b - prev) * w
            prev = b
        return tot

    for p in range(passes):
        order = range(W - 1, -1, -1) if p % 2 == 0 else range(W)
        changed = False
        for i in order:
            lo = r[i - 1] if i > 0 else 0
            hi = r[i + 1] if i < W - 1 else int(cand[-1])
            opts = cand[(cand >= lo) & (cand <= hi)]
            if opts.size == 0:
                continue
            base_cells = cells(r)
            w_next = widths[i + 1] if i < W - 1 else 0
            d_cells = (opts - r[i]) * (widths[i] - w_next)
            feasible = base_cells + d_cells <= budget
            if not feasible.any():
                continue
            # coverage as a function of r_i alone: terms i and i+1 depend on
            # it: ... + (P_i[r_i] - P_i[r_{i-1}]) + (P_{i+1}[r_{i+1}] -
            # P_{i+1}[r_i]) + ... -> gain(b) = P_i[b] - P_{i+1}[b] + const
            Pi = prefixes[i]
            Pn = prefixes[i + 1] if i < W - 1 else None
            gain = Pi[opts].astype(np.int64)
            cur_gain = int(Pi[r[i]])
            if Pn is not None:
                gain = gain - Pn[opts]
                cur_gain -= int(Pn[r[i]])
            gain = np.where(feasible, gain, np.iinfo(np.int64).min)
            j = int(gain.argmax())
            if int(gain[j]) > cur_gain:
                r[i] = int(opts[j])
                changed = True
        if not changed and p > 0:
            break
    return r


def _stair_ladder(n: int, min_width: int = 128, step: float = 2 ** 0.25,
                  ) -> np.ndarray:
    """Geometric candidate-width ladder, 128-lane aligned, ascending, ending
    at exactly n. ~4 candidates per octave is fine enough that snapping to
    the grid costs <1% coverage while keeping the per-nnz classification to
    ~30 compare-add passes."""
    w = float(n)
    out = [n]
    while w > min_width:
        w /= step
        cand = max(min_width, int(round(w / 128.0)) * 128)
        if cand != out[-1] and cand < n:
            out.append(cand)
    return np.unique(np.asarray(out, np.int64))


def _auto_stair(rp: np.ndarray, cp: np.ndarray, m: int, n: int,
                budget: int, align: int, *, min_width: int = 128,
                max_panels: int = 8) -> list[tuple[int, int, int]]:
    """Data-driven panel stair: choose panel WIDTHS and BOUNDARIES jointly
    from the degree distribution under the cell budget.

    Formulation: with users and items degree-sorted, assign every block of
    ``align``-aligned user rows a width w(b) from a geometric candidate
    ladder, maximizing covered nnz  Σ_b cov_b(w(b))  subject to
    Σ_b rows_b · w(b) <= budget and w non-increasing (a stair). Solved by
    Lagrangian relaxation: for a price λ per cell each block independently
    picks argmax_w cov_b(w) − λ·rows_b·w (vectorized over the whole
    (blocks × ladder) table), the choice is projected to non-increasing by a
    reverse running max, and λ is bisected to the budget. The relaxation is
    exact up to one block's rounding because cov_b(w) is near-concave in w
    for degree-sorted power-law data. A final merge pass caps the number of
    distinct widths at ``max_panels`` (each panel is an extra scatter
    program + kernel call set per rank).
    """
    ladder = _stair_ladder(n, min_width=min_width)          # ascending
    K = ladder.size
    # per-nnz ladder class: cls = #{ladder[j] <= cp, j < K-1} via compare-add
    # passes (np.searchsorted over 100M elems measured ~16x slower)
    cls = np.zeros(cp.size, np.int32)
    for t in ladder[:-1]:
        cls += (cp >= np.int32(t))
    # block granularity: align-multiple, <= ~4096 blocks for the search
    B = align * max(1, -(-m // (align * 4096)))
    nblk = -(-m // B)
    key = (rp // np.int32(B)) * np.int32(K) + cls
    counts = key_count(key, nblk * K).reshape(nblk, K)
    covB = np.cumsum(counts, axis=1)       # covB[b, j]: block-b nnz in
    #                                        items [0, ladder[j])
    rows_b = np.full(nblk, B, np.int64)
    rows_b[-1] = m - B * (nblk - 1)
    cost = rows_b[:, None] * ladder[None, :]                # (nblk, K)

    def eval_lam(lam: float):
        score = covB - lam * cost
        j = score.argmax(axis=1)
        w_j = np.where(score[np.arange(nblk), j] > 0, j, -1)  # -1 = no panel
        # stair projection: widths non-increasing down the degree order
        w_j = np.maximum.accumulate(w_j[::-1])[::-1]
        cells = int(np.where(w_j >= 0, rows_b * ladder[np.maximum(w_j, 0)],
                             0).sum())
        return cells, w_j

    cells0, w0 = eval_lam(0.0)
    if cells0 <= budget:
        w_best = w0                        # budget covers the full matrix
    else:
        lo, hi = 0.0, 1.0
        while eval_lam(hi)[0] > budget:
            hi *= 4.0
        w_best = None
        for _ in range(64):
            mid = 0.5 * (lo + hi)
            cells, w_j = eval_lam(mid)
            if cells <= budget:
                hi, w_best = mid, w_j
            else:
                lo = mid
        if w_best is None:
            w_best = eval_lam(hi)[1]

    def total_cells(w_j):
        return int(np.where(w_j >= 0, rows_b * ladder[np.maximum(w_j, 0)],
                            0).sum())

    # merge to <= max_panels distinct width levels: raise the lower level to
    # the upper when the budget allows (coverage can only grow), otherwise
    # lower the upper level (cheapest coverage loss first)
    def levels(w_j):
        lv, prev = [], None
        for b in range(nblk):
            if w_j[b] < 0:
                break
            if w_j[b] != prev:
                lv.append([b, b + 1, int(w_j[b])])
                prev = w_j[b]
            else:
                lv[-1][1] = b + 1
        return lv

    w_j = w_best.copy()
    while True:
        lv = levels(w_j)
        if len(lv) <= max_panels:
            break
        best = None                          # (tier, penalty, i, mode)
        for i in range(len(lv) - 1):
            (a0, a1, ja), (b0, b1, jb) = lv[i], lv[i + 1]
            d_cells = int((rows_b[b0:b1]
                           * (ladder[ja] - ladder[jb])).sum())
            if total_cells(w_j) + d_cells <= budget:
                cand = (0, d_cells, i, "raise")   # coverage only grows
            else:
                loss = int((covB[a0:a1, ja] - covB[a0:a1, jb]).sum())
                cand = (1, loss, i, "lower")
            if best is None or cand < best:
                best = cand
        _, _, i, mode = best
        (a0, a1, ja), (b0, b1, jb) = levels(w_j)[i], levels(w_j)[i + 1]
        if mode == "raise":
            w_j[b0:b1] = ja
        else:
            w_j[a0:a1] = jb

    panels: list[tuple[int, int, int]] = []
    for b0, b1, j in levels(w_j):
        r0, r1 = int(b0) * B, min(int(b1) * B, m)
        if r1 > r0:
            panels.append((int(r0), int(r1), int(ladder[j])))
    return panels


def resolve_hybrid_transpose(R: RatingMatrix, cfg: Config) -> bool:
    """Resolve cfg.hybrid_transpose to a concrete orientation. "auto"
    geometry-plans BOTH orientations (no dense materialization, no device
    work) and picks the smaller uncovered tail (min nnz_light at equal
    budget)."""
    return plan_oriented(R, cfg)[0]


def plan_oriented(R: RatingMatrix, cfg: Config
                  ) -> tuple[bool, Optional[HybridPlan]]:
    """(transposed, plan): the orientation ``cfg.hybrid_transpose`` asks for
    and, where choosing it planned that orientation ("auto" plans both,
    with ``materialize_dense=False``), its plan, else None."""
    if not cfg.hybrid_transpose:
        return False, None
    if cfg.hybrid_transpose is True:
        return True, None
    cfg_nt = dataclasses.replace(cfg, hybrid_transpose=False)
    plan_n = plan_hybrid(R, cfg_nt, materialize_dense=False)
    plan_t = plan_hybrid(R.transpose(), cfg_nt, materialize_dense=False)
    if plan_t.nnz_light < plan_n.nnz_light:
        return True, plan_t
    return False, plan_n


def transpose_test(T: TestCOO) -> TestCOO:
    """The held-out ratings of the transposed problem."""
    return make_test(T.cols, T.rows, T.col_idx, T.row_idx, T.val)


def plan_hybrid(R: RatingMatrix, cfg: Config, *,
                materialize_dense: bool = True,
                num_shards: int = 1) -> HybridPlan:
    """Choose panel boundaries maximizing covered nnz under the cell budget
    (``cfg.hybrid_dense_cells``) by grid search over degree-sorted user
    boundaries, one per panel width (full n plus
    ``cfg.hybrid_panel_widths``). With ``num_shards = N`` every panel's row
    count is N-aligned (device row blocks are equal) and the ELL remainder
    is built shard-uniform (data/ell.py)."""
    m, n = R.rows, R.cols
    deg_u = R.row_nnz.astype(np.int64)
    deg_i = R.col_nnz.astype(np.int64)
    user_order = np.argsort(-deg_u, kind="stable").astype(np.int64)
    item_order = np.argsort(-deg_i, kind="stable").astype(np.int64)
    user_pos = np.empty(m, np.int64)
    user_pos[user_order] = np.arange(m)
    item_pos = np.empty(n, np.int64)
    item_pos[item_order] = np.arange(n)

    r, c, v = R.to_coo()
    rp = user_pos.astype(np.int32)[r]
    cp = item_pos.astype(np.int32)[c]

    align = 8 * num_shards // np.gcd(8, num_shards)     # lcm(8, N)
    budget = int(cfg.hybrid_dense_cells)
    if cfg.hybrid_panel_widths == "auto":
        # data-driven stair: widths AND boundaries chosen from the degree
        # distribution under the budget (Lagrangian + stair projection)
        panels = _auto_stair(rp, cp, m, n, budget, align,
                             max_panels=cfg.hybrid_max_panels)
        return _finish_plan(R, cfg, materialize_dense, num_shards, panels,
                            user_order, item_order, user_pos, item_pos,
                            deg_u, deg_i, rp, cp, v)

    widths = [n] + sorted({min(int(w), n) for w in cfg.hybrid_panel_widths
                           if 0 < int(w) < n}, reverse=True)
    # coverage prefix per width: P_w[x] = nnz of the x top users inside the
    # top-w items. One fused histogram over (user position x width class)
    # replaces a boolean-select + bincount pass per width.
    sub = np.asarray(widths[:0:-1], dtype=np.int64)        # ascending, < n
    ncls = sub.size + 1
    # class id by comparison chain: np.searchsorted over a 100M-element
    # int32 array against an int64 needle list measured ~16 s (dtype
    # promotion + generic binary search); |sub| compare-add passes are ~1 s
    key = rp * np.int32(ncls)
    for t in sub:
        key += cp >= np.int32(t)
    counts2d = key_count(key, m * ncls).reshape(m, ncls)
    csum = np.cumsum(counts2d, axis=1)     # csum[:, i]: nnz with cp < sub[i]
    prefixes = []
    for w in widths:                       # descending, n first
        cov = (csum[:, ncls - 1] if w >= n
               else csum[:, int(np.searchsorted(sub, w))])
        prefixes.append(np.concatenate([[0], np.cumsum(cov)]))

    cand = _candidate_boundaries(m, align, include_full=(num_shards == 1))
    best_r = _search_boundaries(prefixes, widths, cand, budget)

    panels = []
    r_prev = 0
    for rb, w in zip(best_r, widths):
        if rb > r_prev:
            panels.append((r_prev, rb, w))
            r_prev = rb

    return _finish_plan(R, cfg, materialize_dense, num_shards, panels,
                        user_order, item_order, user_pos, item_pos,
                        deg_u, deg_i, rp, cp, v)


def _finish_plan(R, cfg, materialize_dense, num_shards, panels,
                 user_order, item_order, user_pos, item_pos,
                 deg_u, deg_i, rp, cp, v) -> HybridPlan:
    """Split the degree-sorted COO into panel cells vs the sparse remainder
    for a given panel stair and assemble the HybridPlan."""
    m, n = R.rows, R.cols
    # split COO: panel cells vs sparse remainder — ONE stable partition by
    # panel id (remainder last) instead of a boolean-mask cascade per panel;
    # within each group the COO (CSR) order is preserved, byte-identical to
    # the mask formulation.
    P = len(panels)
    wband = np.asarray([w for _, _, w in panels] + [0], dtype=np.int32)
    band = np.zeros(rp.size, np.int32)
    for _, r1, _ in panels:                # <= a few compare-add passes
        band += rp >= np.int32(r1)
    pkey = np.where(cp < wband[band], band, np.int32(P))
    gptr, perm = stable_perm(pkey, P + 1)
    rp_s = rp[perm]
    cp_s, v_s = perm_gather(perm, cp, np.ascontiguousarray(v, np.float32))

    Rd, Md, panel_coo = [], [], []
    for p, (r0, r1, w) in enumerate(panels):
        seg = slice(gptr[p], gptr[p + 1])
        lr = (rp_s[seg] - r0).astype(np.int32)
        lc = cp_s[seg]
        lv = v_s[seg]
        if materialize_dense:
            A = np.zeros((r1 - r0, w), np.float32)
            M = np.zeros((r1 - r0, w), np.float32)
            A[lr, lc] = lv
            M[lr, lc] = 1.0
            Rd.append(A)
            Md.append(M)
        else:
            panel_coo.append((lr, lc, lv))

    lseg = slice(gptr[P], gptr[P + 1])
    R_light = from_coo(m, n, rp_s[lseg], cp_s[lseg], v_s[lseg])
    ell = build_ell_pair(R_light, min_width=cfg.ell_min_width,
                         num_shards=num_shards, index_space="entity")
    rows, cols = ell.rows_side, ell.cols_side

    return HybridPlan(
        user_order=user_order, item_order=item_order,
        user_pos=user_pos, item_pos=item_pos,
        panels=tuple(panels), ell=ell, nnz_light=int(gptr[P + 1] - gptr[P]),
        Rd=tuple(Rd), Md=tuple(Md),
        row_nnz=deg_u[user_order].astype(np.float32),
        col_nnz=deg_i[item_order].astype(np.float32),
        slot_of_upos=rows.slot_of_entity.astype(np.int32),
        slot_of_ipos=cols.slot_of_entity.astype(np.int32),
        upos_of_slot_safe=np.where(rows.entity_of_slot < 0, m,
                                   rows.entity_of_slot).astype(np.int32),
        ipos_of_slot_safe=np.where(cols.entity_of_slot < 0, n,
                                   cols.entity_of_slot).astype(np.int32),
        panel_coo=tuple(panel_coo) if panel_coo else None,
    )


# ---------------------------------------------------------------- device half

@dataclasses.dataclass(frozen=True)
class HybridDevicePlan:
    """The plan's index and degree arrays on the training device."""

    idx_r: tuple               # per rows-side bucket (rows, L) int64
    idx_c: tuple               # per cols-side bucket
    row_nnz: torch.Tensor      # (m,) f32 total degrees, sorted order
    col_nnz: torch.Tensor      # (n,)
    upos_safe: torch.Tensor    # (n_row_slots,) int64, padding -> m
    ipos_safe: torch.Tensor    # (n_col_slots,) int64, padding -> n
    slot_of_upos: torch.Tensor  # (m,) int64
    slot_of_ipos: torch.Tensor  # (n,) int64


def device_plan(plan: HybridPlan, device) -> HybridDevicePlan:
    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return HybridDevicePlan(
        idx_r=tuple(i64(b.idx) for b in plan.ell.rows_side.buckets),
        idx_c=tuple(i64(b.idx) for b in plan.ell.cols_side.buckets),
        row_nnz=f32(plan.row_nnz), col_nnz=f32(plan.col_nnz),
        upos_safe=i64(plan.upos_of_slot_safe),
        ipos_safe=i64(plan.ipos_of_slot_safe),
        slot_of_upos=i64(plan.slot_of_upos),
        slot_of_ipos=i64(plan.slot_of_ipos))


def densify_panels(plan: HybridPlan, dtype: torch.dtype, device,
                   mask_dtype: str = "nan") -> tuple[list, list]:
    """Scatter each panel's COO (``plan_hybrid(materialize_dense=False)``)
    into its (r1 - r0, w) residual on ``device``, one panel at a time.
    Returns (residuals, masks): with ``mask_dtype="nan"`` unobserved cells
    hold NaN and ``masks`` is EMPTY; with "bfloat16" or "int8" they hold 0
    and each panel has a {0,1} mask of that dtype. No block padding: the
    kernels mask the ragged edge."""
    if plan.panels and plan.panel_coo is None:
        raise ValueError("densify_panels needs a plan built with "
                         "materialize_dense=False (per-panel COO)")
    Rds, masks = [], []
    for (lr, lc, lv), (r0, r1, w) in zip(plan.panel_coo or (), plan.panels):
        if mask_dtype == "nan":
            Rds.append(densify_coo_nan(lr, lc, lv, r1 - r0, w, dtype,
                                       device))
        else:
            Rd, Md = densify_coo_mask(lr, lc, lv, r1 - r0, w, dtype,
                                      mask_dtype, device)
            Rds.append(Rd)
            masks.append(Md)
    return Rds, masks


def initial_state(plan: HybridPlan, W0: np.ndarray, dtype: torch.dtype,
                  device, mask_dtype: str = "nan") -> HybridState:
    """Training state at outer iteration 1: panels and ELL values hold the
    ratings, W is ``W0`` in degree-sorted user order, H is zero
    (src/CCD.cpp:56-60) and nothing is pending."""
    m, n = plan.row_nnz.shape[0], plan.col_nnz.shape[0]
    k = W0.shape[0]
    W = np.ascontiguousarray(np.asarray(W0, np.float32)[:, plan.user_order])
    zeros = dict(dtype=torch.float32, device=device)
    Rds, masks = densify_panels(plan, dtype, device, mask_dtype)
    return HybridState(
        Rds=Rds, masks=masks,
        vals_r=[torch.as_tensor(b.val, device=device).clone()
                for b in plan.ell.rows_side.buckets],
        vals_c=[torch.as_tensor(b.val, device=device).clone()
                for b in plan.ell.cols_side.buckets],
        W=torch.as_tensor(W, device=device).clone(),
        H=torch.zeros((k, n), **zeros),
        u_pend=torch.zeros(m, **zeros), v_pend=torch.zeros(n, **zeros))


def hybrid_store_order(cfg: Config) -> str:
    """K1's and K4's store order for the hybrid ``cfg``, the JAX package's
    own (``store_order``): "once" with the panel kernels (the Pallas K1),
    else at fp8 "delta_first" (the XLA einsum path: explicit masks, NaN
    panels without the kernel); "once" at f32 and bf16."""
    return store_order(RESIDUAL_DTYPES[cfg.residual_dtype],
                       rounds_once=cfg.hybrid_panel_kernel)


def make_hybrid_outer_step(plan: HybridPlan, dplan: HybridDevicePlan,
                           lam: float, maxinneriter: int, *, order: str,
                           nmf: bool = False,
                           reduce: Optional[Callable] = None,
                           defer_group: int = 0,
                           ) -> Callable[[HybridState], torch.Tensor]:
    """One outer iteration over all k ranks (a Python loop), all parts,
    updating ``state`` IN PLACE (the JAX step donates these buffers).
    Returns the state's W.

    Per rank t (the JAX package's panel-kernel schedule): K1 applies the
    deferred subtract of rank t-1 and the add-back of rank t to every panel
    and returns the v-sweep partials; the cols-side ELL tail does the same
    in one gather pass; v = g / (λ·nnz + h). Then K2 and the rows-side tail
    give the u-sweep partials with the new v; u = g / (λ·nnz + h). Inner
    iterations i > 0 re-sweep with K3 and ``fused_sweep``, without
    updates. W[t], H[t] take (u, v), which also become the pending outer
    product. A state with explicit panel masks (``state.masks``) runs K4,
    ``masked_usweep`` and ``masked_vsweep`` in those three places.
    ``order`` is K1's and K4's store order: "once", or at an fp8 residual
    "delta_first", the order of the JAX package's einsum panel path
    (explicit masks, or NaN panels without the panel kernel); a caller
    with a Config takes it from ``hybrid_store_order``.

    ``defer_group`` G > 0 (the JAX package's rank-deferred ELL tail,
    ignored without a tail): the tail's residual values stay frozen for G
    ranks. Each rank's two rank-1 deltas, the deferred subtract of rank
    t-1 (u_pend, v_pend; sign -1) and the add-back of rank t (u_old, v_old;
    sign +1), go into columns 2j and 2j+1 (j = t mod G) of the tables U_def
    (m, 2G) and V_def (n, 2G); every sweep of the tail is ``deferred_sweep``
    against the frozen values plus ``fused_remap_combine``'s algebraic
    corrections; and ``deferred_flush`` applies the group's 2G deltas in one
    pass at t mod G = G - 1 and at the last rank (so a step ends with
    current values, and checkpoints do not change). The panels take each
    rank's update through K1/K4 as without G.

    ``reduce(g, h) -> (g, h)`` (the sharded step, parallel/
    ccd_hybrid_sharded.py) sums each half-sweep's partials over the ranks
    before the division; ``plan`` is then the rank's part of the plan
    (``local_plan``): its panels' row blocks and its shard of the tail.

    Profiler spans: each half-sweep's panel loop is ``crtpu.ccd.panels``,
    its ELL tail and each flush ``crtpu.ccd.tail``; the zeroing, the
    reduce, the divisions and the state writes are the caller's span."""
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    panels = plan.panels
    have_light = plan.nnz_light > 0
    m, n = plan.row_nnz.shape[0], plan.col_nnz.shape[0]
    d = dplan
    G = int(defer_group) if have_light else 0
    dsigns = tuple(-1.0 if c % 2 == 0 else 1.0 for c in range(2 * G))
    if reduce is None:
        def reduce(g, h):
            return g, h

    def flush(st: HybridState, U_def, V_def) -> None:
        """Apply the group's 2G deferred deltas to both tail sides, then
        clear the tables. The flush needs slot-space own vectors: the 2G
        columns are remapped once here."""
        with span("crtpu.ccd.tail"):
            OV = torch.stack(stacked_remap(V_def.unbind(1), d.ipos_safe))
            OU = torch.stack(stacked_remap(U_def.unbind(1), d.upos_safe))
            deferred_flush(d.idx_c, st.vals_c, cols, extend_zero(U_def), OV,
                           dsigns)
            deferred_flush(d.idx_r, st.vals_r, rows, extend_zero(V_def), OU,
                           dsigns)
        U_def.zero_()
        V_def.zero_()

    def cols_tail(st: HybridState, i: int, u, u_old, v_old, U_def, V_def,
                  g, h) -> tuple:
        """The v-sweep's ELL tail: (g, h) plus the tail's partials."""
        with span("crtpu.ccd.tail"):
            if G:
                # against the frozen values, corrected for the group's
                # recorded deltas in entity space
                S0, Sc, h_l = deferred_sweep(
                    d.idx_c, st.vals_c, cols,
                    extend_zero(torch.cat([u[:, None], U_def], 1)))
                g_e, h_e = fused_remap_combine([S0] + Sc, h_l,
                                               d.slot_of_ipos, V_def.T,
                                               dsigns)
            else:
                if i == 0:
                    ovp, ovo = stacked_remap((st.v_pend, v_old),
                                             d.ipos_safe)
                    g_l, h_l = fused_update_sweep(
                        d.idx_c, st.vals_c, cols,
                        extend_zero(torch.stack([st.u_pend, u_old], -1)),
                        owns=(ovp, ovo), signs=(-1.0, 1.0), sweep_col=1)
                else:
                    g_l, h_l = fused_sweep(
                        d.idx_c, st.vals_c, cols,
                        extend_zero(torch.stack([u, u], -1)), sweep_col=0)
                g_e, h_e = stacked_remap((g_l, h_l), d.slot_of_ipos)
            return g + g_e, h + h_e

    def rows_tail(st: HybridState, i: int, v, u_old, v_old, U_def, V_def,
                  gu, hu) -> tuple:
        """The u-sweep's ELL tail: (gu, hu) plus the tail's partials."""
        with span("crtpu.ccd.tail"):
            if G:
                S0r, Scr, h_lr = deferred_sweep(
                    d.idx_r, st.vals_r, rows,
                    extend_zero(torch.cat([v[:, None], V_def], 1)))
                gu_e, hu_e = fused_remap_combine([S0r] + Scr, h_lr,
                                                 d.slot_of_upos, U_def.T,
                                                 dsigns)
            else:
                if i == 0:
                    # the deferred subtract of rank t-1, the add-back, and
                    # the sweep with the NEW v in one 3-wide gather pass
                    oup, ouo = stacked_remap((st.u_pend, u_old),
                                             d.upos_safe)
                    g_lr, h_lr = fused_update_sweep(
                        d.idx_r, st.vals_r, rows,
                        extend_zero(torch.stack([st.v_pend, v_old, v], -1)),
                        owns=(oup, ouo), signs=(-1.0, 1.0), sweep_col=2)
                else:
                    g_lr, h_lr = fused_sweep(
                        d.idx_r, st.vals_r, rows,
                        extend_zero(torch.stack([v, v], -1)), sweep_col=0)
                gu_e, hu_e = stacked_remap((g_lr, h_lr), d.slot_of_upos)
            return gu + gu_e, hu + hu_e

    def rank(st: HybridState, t: int, U_def, V_def) -> None:
        u_old, v_old = st.W[t], st.H[t]
        u, v = u_old, v_old
        f32 = dict(dtype=torch.float32, device=st.W.device)
        masks = st.masks or [None] * len(panels)
        if G:
            # this rank's two deferred deltas at columns (2j, 2j + 1)
            j = 2 * (t % G)
            U_def[:, j], U_def[:, j + 1] = st.u_pend, u_old
            V_def[:, j], V_def[:, j + 1] = st.v_pend, v_old
        for i in range(maxinneriter):
            # ---- v-sweep (items): panel partials + ELL partials ----
            g, h = torch.zeros(n, **f32), torch.zeros(n, **f32)
            with span("crtpu.ccd.panels"):
                for (r0, r1, w), Rd, Mk in zip(panels, st.Rds, masks):
                    if i == 0:
                        vecs = (u_old[r0:r1], st.u_pend[r0:r1], v_old[:w],
                                st.v_pend[:w])
                        gp, hp = (
                            panel_update_vsweep(Rd, *vecs, order=order)
                            if Mk is None else
                            fused_update_vsweep(Rd, Mk, *vecs, order=order))
                    elif Mk is None:
                        gp, hp = panel_vsweep(Rd, u[r0:r1])
                    else:
                        gp, hp = masked_vsweep(Rd, Mk, u[r0:r1])
                    g[:w] += gp
                    h[:w] += hp
            if have_light:
                g, h = cols_tail(st, i, u, u_old, v_old, U_def, V_def, g, h)
            v = _half_sweep(*reduce(g, h), lam, d.col_nnz, nmf)

            # ---- u-sweep (users) ----
            gu, hu = torch.zeros(m, **f32), torch.zeros(m, **f32)
            with span("crtpu.ccd.panels"):
                for (r0, r1, w), Rd, Mk in zip(panels, st.Rds, masks):
                    gp, hp = (panel_usweep(Rd, v[:w]) if Mk is None
                              else masked_usweep(Rd, Mk, v[:w]))
                    gu[r0:r1] += gp
                    hu[r0:r1] += hp
            if have_light:
                gu, hu = rows_tail(st, i, v, u_old, v_old, U_def, V_def,
                                   gu, hu)
            u = _half_sweep(*reduce(gu, hu), lam, d.row_nnz, nmf)

        # ---- write back (src/CCD.cpp:128-134); the subtract of rank t's
        # new outer product is deferred to rank t+1 via (u_pend, v_pend) ----
        st.W[t] = u
        st.H[t] = v
        st.u_pend, st.v_pend = u, v
        if G and (t % G == G - 1 or t == st.W.shape[0] - 1):
            flush(st, U_def, V_def)

    def step(st: HybridState) -> torch.Tensor:
        U_def = V_def = None
        if G:
            f32 = dict(dtype=torch.float32, device=st.W.device)
            U_def = torch.zeros((m, 2 * G), **f32)
            V_def = torch.zeros((n, 2 * G), **f32)
        for t in range(st.W.shape[0]):
            rank(st, t, U_def, V_def)
        return st.W

    return step


def make_hybrid_phase_fns(plan: HybridPlan, dplan: HybridDevicePlan,
                          lam: float, maxinneriter: int, *,
                          nmf: bool = False,
                          reduce: Optional[Callable] = None):
    """Phase-split step functions for phase timing (solvers/phase_loop.py):
    the reference's plain schedule (add-back, sweeps, immediate subtract,
    src/CCD.cpp:74-139), each phase one fenceable pass over ALL parts
    (panels and both ELL tail sides). Each is ``fn(state, t)`` and updates
    the state in place; the pending outer product is not used.

    The sweeps run K3 ``panel_vsweep`` and K2 ``panel_usweep`` on NaN
    panels (``masked_vsweep``, ``masked_usweep`` beside explicit masks)
    and the tail's ``sweep_partials`` (the JAX package's ccd_hybrid.py:
    893-975). The update phases are plain torch, as XLA computes them in
    the JAX package (its ``_panel_update`` and ``_ell_update``,
    ccd_hybrid.py:840-868): ``rank1_update`` rounds the delta to the
    panel's dtype and then the sum. ``reduce``: as in
    ``make_hybrid_outer_step`` (the sharded phase functions)."""
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    panels = plan.panels
    have_light = plan.nnz_light > 0
    m, n = plan.row_nnz.shape[0], plan.col_nnz.shape[0]
    d = dplan
    if reduce is None:
        def reduce(g, h):
            return g, h

    def _both(st: HybridState, t: int, sign: float) -> None:
        u, v = st.W[t], st.H[t]
        for (r0, r1, w), Rd, Mk in zip(panels, st.Rds,
                                       st.masks or [None] * len(panels)):
            rank1_update(Rd, Mk, u[r0:r1], v[:w], sign)
        if have_light:
            u_ext, v_ext = extend_zero(u), extend_zero(v)
            residual_update(d.idx_c, st.vals_c, cols, u_ext,
                            v_ext[d.ipos_safe], sign)
            residual_update(d.idx_r, st.vals_r, rows, v_ext,
                            u_ext[d.upos_safe], sign)

    def addback(st: HybridState, t: int) -> None:
        _both(st, t, 1.0)

    def subtract(st: HybridState, t: int) -> None:
        _both(st, t, -1.0)

    def sweeps(st: HybridState, t: int) -> None:
        u, v = st.W[t], st.H[t]
        f32 = dict(dtype=torch.float32, device=st.W.device)
        masks = st.masks or [None] * len(panels)
        for _ in range(maxinneriter):      # src/CCD.cpp:107-123
            g, h = torch.zeros(n, **f32), torch.zeros(n, **f32)
            for (r0, r1, w), Rd, Mk in zip(panels, st.Rds, masks):
                gp, hp = (panel_vsweep(Rd, u[r0:r1]) if Mk is None
                          else masked_vsweep(Rd, Mk, u[r0:r1]))
                g[:w] += gp
                h[:w] += hp
            if have_light:
                g_l, h_l = sweep_partials(d.idx_c, st.vals_c, cols,
                                          extend_zero(u))
                g = g + extend_zero(g_l)[d.slot_of_ipos]
                h = h + extend_zero(h_l)[d.slot_of_ipos]
            v = _half_sweep(*reduce(g, h), lam, d.col_nnz, nmf)

            gu, hu = torch.zeros(m, **f32), torch.zeros(m, **f32)
            for (r0, r1, w), Rd, Mk in zip(panels, st.Rds, masks):
                gp, hp = (panel_usweep(Rd, v[:w]) if Mk is None
                          else masked_usweep(Rd, Mk, v[:w]))
                gu[r0:r1] += gp
                hu[r0:r1] += hp
            if have_light:
                g_lr, h_lr = sweep_partials(d.idx_r, st.vals_r, rows,
                                            extend_zero(v))
                gu = gu + extend_zero(g_lr)[d.slot_of_upos]
                hu = hu + extend_zero(h_lr)[d.slot_of_upos]
            u = _half_sweep(*reduce(gu, hu), lam, d.row_nnz, nmf)
        st.W[t] = u
        st.H[t] = v

    return addback, sweeps, subtract


def ccd_hybrid_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                     T: TestCOO, cfg: Config, *, device="cuda",
                     callback: Optional[Callable[[IterStats], None]] = None,
                     plan: Optional[HybridPlan] = None,
                     log: Optional[MetricsLog] = None,
                     run: Optional[dict] = None,
                     ckpt_every: int = 0, ckpt_fn=None, resume=None,
                     rank_callback=None,
                     ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train CCD++ on the panel-hybrid backend on ``device``. Returns
    (W, H, stats) in the reference's rank-major ORIGINAL entity order.
    ``H0`` is accepted for the solvers' common signature; CCD++ zeroes H at
    entry (src/CCD.cpp:56-60). With ``log``, the plan and the host set-up
    times are reported as an info line and a ``hybrid_plan`` event. With
    ``run`` (a dict), the run's one orientation decision and what it set up
    are written there for the caller: ``transposed``, ``plan`` (the plan
    the run used, in that orientation), ``plan_s`` and ``setup_s`` (host
    seconds to plan, then to set up the device state).

    ``cfg.hybrid_transpose``: True runs the SAME solver on Rᵀ — the stair
    covers top-items x user prefixes, the item side carries the seeded
    factors (``H0``) and users are swept first; the factors swap back on
    return, so the caller's contract is unchanged. "auto" plans both
    orientations and keeps the smaller tail (``plan_oriented``). The
    transposed trajectory equals the reference run on the transposed
    problem, not the untransposed one. A given ``plan`` is taken as planned
    for ``R`` as it stands (no transpose).

    Every ``ckpt_every`` outer iterations ``ckpt_fn(oiter, payload)`` gets
    host copies of the whole state in the plan's orientation (the JAX
    payload, solvers/hybrid_state.py; with ``cfg.hybrid_panel_kernel``
    the panels block-padded with NaN as the JAX panel-kernel path stores
    them); ``resume`` (such a payload plus its ``oiter``) continues a run.
    With ``cfg.phase_timing`` the phases are fenced and timed apart
    (``rank_callback(oiter, t, dt, rmse)`` per rank)."""
    if cfg.phase_timing:
        refuse_pending(resume)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    transposed = False
    if plan is None:
        transposed, plan = plan_oriented(R, cfg)
        if transposed:
            R, W0, T = R.transpose(), H0, transpose_test(T)
        if plan is None:
            plan = plan_hybrid(R, cfg, materialize_dense=False)
    t1 = time.perf_counter()
    dplan = device_plan(plan, dev)
    rdt = RESIDUAL_DTYPES[cfg.residual_dtype]
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
        state = hybrid_state_from_numpy(resume, plan, dev, cfg.mask_dtype,
                                        dtype=rdt)
    else:
        state = initial_state(plan, W0, rdt, dev, cfg.mask_dtype)
    synchronize(dev)
    t2 = time.perf_counter()
    if run is not None:
        run.update(transposed=transposed, plan=plan, plan_s=t1 - t0,
                   setup_s=t2 - t1)
    if log is not None:
        cells = sum((r1 - r0) * w for r0, r1, w in plan.panels)
        log.info(f"[info] hybrid plan: {len(plan.panels)} panels "
                 f"{list(plan.panels)}, {cells} panel cells, tail nnz "
                 f"{plan.nnz_light} of {R.nnz}; plan {t1 - t0:.3f} s, "
                 f"device set-up {t2 - t1:.3f} s"
                 + ("; the transposed matrix" if transposed else ""))
        log.event("hybrid_plan", panels=[list(p) for p in plan.panels],
                  mask_dtype=cfg.mask_dtype, panel_cells=cells, nnz=R.nnz,
                  nnz_light=plan.nnz_light, transposed=transposed,
                  plan_s=t1 - t0, setup_s=t2 - t1)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti_np, tj_np = plan.user_pos[T.row_idx], plan.item_pos[T.col_idx]
    ti, tj = i64(ti_np), i64(tj_np)
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)
    shapes = ([padded_panel_shape(r1 - r0, w) for r0, r1, w in plan.panels]
              if cfg.hybrid_panel_kernel else None)
    common = dict(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        do_rmse=lambda: calrmse_device(ti, tj, tv, state.W, state.H,
                                       entity_major=False, chunk=chunk),
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=lambda: hybrid_state_to_numpy(state,
                                                  panel_shapes=shapes),
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)
    lam, inner, nmf = cfg.lambda_, cfg.maxinneriter, cfg.do_nmf

    if cfg.phase_timing:
        # the phase schedule has no deferred tail (the JAX package's
        # phase functions take no defer group either)
        ab, sw, sub = make_hybrid_phase_fns(plan, dplan, lam, inner, nmf=nmf)
        stats = phased_ccd_loop(
            k=W0.shape[0], device=dev,
            addback=lambda t: ab(state, t), sweeps=lambda t: sw(state, t),
            subtract=lambda t: sub(state, t),
            get_rank_rows=rank_rows(state),
            ti=ti_np, tj=tj_np, tv=np.asarray(T.val),
            rank_callback=rank_callback, **common)
    else:
        step = make_hybrid_outer_step(
            plan, dplan, lam, inner, nmf=nmf,
            order=hybrid_store_order(cfg),
            defer_group=cfg.hybrid_defer_group)
        stats = pipelined_loop(fuse=cfg.fused_outer_iters,
                               do_step=lambda: step(state), **common)

    W = state.W.cpu().numpy()[:, plan.user_pos]      # unsort to orig order
    H = state.H.cpu().numpy()[:, plan.item_pos]
    return (H, W, stats) if transposed else (W, H, stats)
