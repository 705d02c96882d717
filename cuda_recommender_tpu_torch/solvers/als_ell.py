"""ALS — padded-ELL backend on one GPU, with the batched Gauss-Jordan kernel.

The port of ``cuda_recommender_tpu/solvers/als_ell.py``, the counterpart of
the reference's ALS paths (reference src/ALS.cpp:81-233,
cuda_src/ALS_CUDA.cu:65-180). The reference gives each user/item one CUDA
thread that builds a k×k gram from CSR-gathered factor rows and inverts it.
Here each degree bucket of the ELL layout (data/ell.py) gathers the other
side's factor rows for all its slots at once, forms every slot's gram AND
right-hand side with one batched product of Faug = [F | val] with itself,
and solves all k×k systems with K5, the hand-written batched Gauss-Jordan
kernel (ops/gj_kernels.py, csrc/gj_kernels.cu): a solve, not the
reference's explicit inverse (src/ALS.cpp:41-64) — same math, better
numerics.

``als_precision`` sets the gram product as the JAX package's
``jax.lax.Precision`` sets its einsum on the TPU (``als_ell.py:366-370``),
the precision coming from the operands' dtypes alone (no process-wide
matmul flag changes; core/device.py):

* "highest": true f32, one f32 ``torch.bmm`` (TF32 stays off).
* "high": bf16x3. Faug splits into bf16 ``hi = bf16(x)`` and
  ``lo = bf16(x - hi)``; G = hi·hi + hi·lo + lo·hi, three bf16 tensor-core
  products with f32 results, summed in f32 (the lo·lo term dropped, as
  the TPU drops it).
* "default": one bf16 pass: Faug, the ratings included, rounded to bf16,
  one bf16 product with an f32 result.

The bf16 operands come from bf16 gather tables, split or rounded once per
side (the same values as rounding after the gather, half the gather's
bytes), padded with zero columns to a multiple of 8 so that a gathered row
is 16-byte aligned (cuBLAS keeps the Hopper tensor-core kernels; at 41
bf16 columns it takes a Turing-era kernel of 2-byte alignment). Products of
bf16 values are exact in f32, so the plain version (the CPU path, and the
oracle on the card) widens the bf16 operands to f32 and multiplies in f32:
it differs from the card's product only in the order of the f32 sums.

Semantics preserved (SURVEY.md §7): λ added UNscaled to the gram diagonal
(src/ALS.cpp:121); empty entities get zero factors (src/ALS.cpp:151-157);
the H update within an iteration uses the NEW W (Gauss-Seidel across sides,
Jacobi within a side — src/ALS.cpp:98-219); entity-major (n, k) layout
(src/main.cpp:87-91). Factors live in slot space during training
(solvers/als_state.py).

Not ported from the JAX module: the lane-axis chunking of the gram scan
(a VMEM bound; the port bounds memory by row groups), the (8, 128) tile
padding in the group budget, and the gather-cliff tiling (ROADMAP.md "Not
ported"; a run that would have tiled logs one line and runs untiled, the
same math).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..core.config import Config
from ..core.device import resolve_device, synchronize
from ..core.metrics_log import MetricsLog
from ..data.ell import EllBucket, EllPair, EllSide, _resolve_min_width
from ..data.ell import build_ell_pair
from ..data.sparse import RatingMatrix, TestCOO
from ..eval.metrics import calrmse_device, default_eval_chunk
from ..ops.gj_kernels import gj_solve, gj_solve_plain
from ..utils.timing import span
from .als_state import als_state_from_numpy, als_state_to_numpy, slot_payload
from .pipeline import pipelined_loop
from .reference import IterStats

#: per-group temp budget of the assembly + solve (cfg.als_group_mb's
#: default): bounds each group's gathered Faug, its augmented grams and its
#: solutions, in true bytes
GROUP_TEMP_BYTES = 2 << 30


#: the gram product's precisions (Config.als_precision)
PRECISIONS = ("highest", "high", "default")


def augmented_table(other: torch.Tensor, width: Optional[int] = None
                    ) -> torch.Tensor:
    """The other side's factors (n, k) as the gather table of the augmented
    assembly: (n + 1, width) f32, width k + 1 by default; zero row n (the
    ELL pad lanes' zero slot, ``extend_zero``), column k where each lane's
    rating goes, and zero columns after it."""
    n, k = other.shape
    table = other.new_zeros((n + 1, width or k + 1))
    table[:n, :k] = other
    return table


def _padded_width(k: int) -> int:
    """The bf16 tables' width: k + 1 rounded up to a multiple of 8 (16
    bytes a row)."""
    return -(-(k + 1) // 8) * 8


def operands(x: torch.Tensor, precision: str) -> tuple:
    """f32 ``x`` as the gram product's operands: ``(x,)`` ("highest"),
    ``(bf16(x),)`` ("default") or ``(hi, lo)`` with ``hi = bf16(x)`` and
    ``lo = bf16(x - hi)`` ("high"; ``x - hi`` is exact in f32)."""
    if precision == "highest":
        return (x,)
    hi = x.to(torch.bfloat16)
    if precision == "default":
        return (hi,)
    return hi, (x - hi.float()).to(torch.bfloat16)


def gram_tables(other: torch.Tensor, precision: str) -> tuple:
    """The gather tables of one side's solve: ``operands`` of its
    augmented table; for bf16, (n + 1, c) views, c = ``_padded_width``,
    of tables 4 columns wider (``_gather``)."""
    if precision == "highest":
        return (augmented_table(other),)
    c = _padded_width(other.shape[1])
    return tuple(t[:, :c] for t in operands(augmented_table(other, c + 4),
                                           precision))


def _gather(table: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """``table[lanes]``. A bf16 table is gathered as 64-bit words (4
    values each) from rows of 2c + 8 bytes: PyTorch's index takes its
    element-wise kernel there, where on rows of a multiple of 16 bytes it
    takes one that runs a thread block per index, several times slower at
    these row lengths (PERF.md §6). The gathered rows are contiguous, 2c
    bytes each."""
    if table.dtype == torch.bfloat16:
        return table.view(torch.int64)[lanes].view(torch.bfloat16)
    return table[lanes]


def gram_product_plain(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A^T B per slot, (S, E, c) x (S, E, c) -> (S, c, c) f32: the operands
    widened to f32 (exact for bf16) and one f32 ``bmm``."""
    return torch.bmm(A.transpose(1, 2).float(), B.float())


def gram_product(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``gram_product_plain``'s function. bf16 operands on a CUDA device
    go to the bf16 tensor cores with f32 accumulation and an f32 result
    (``torch.bmm(..., out_dtype=torch.float32)``, CUDA only); f32 operands,
    and operands on the CPU, take the plain version."""
    if A.is_cuda and A.dtype == torch.bfloat16:
        return torch.bmm(A.transpose(1, 2), B, out_dtype=torch.float32)
    return gram_product_plain(A, B)


def gather_operands(idx: torch.Tensor, val: torch.Tensor, tables: tuple,
                    b: EllBucket, k: int, precision: str) -> list:
    """One bucket's Faug per operand of ``operands``: idx (rows, L) int64
    and val (rows, L) f32 -> (S, E, c) tensors, S = rows·p, Faug[s, e] =
    [F[idx[s, e]] | val[s, e] | 0...] gathered from ``gram_tables(·,
    precision)`` (lane-packed rows, p > 1, reshape (rows, L) -> (rows·p,
    E) per-slot lanes; padded lanes gather the zero row with value 0)."""
    S = idx.shape[0] * b.p
    lanes = idx.reshape(S, b.E)
    F = []
    for table, v in zip(tables, operands(val.reshape(S, b.E), precision)):
        f = _gather(table, lanes)                         # (S, E, c)
        f[:, :, k] = v
        F.append(f)
    return F


def _gram_and_rhs(idx: torch.Tensor, val: torch.Tensor, tables: tuple,
                  b: EllBucket, k: int, precision: str = "highest"):
    """Per-slot gram and rhs of one bucket's rows -> G (S, k, k), r (S, k),
    both views of one augmented (S, c, c) product Gaug[s] = Faug[s]^T
    Faug[s] (``gather_operands``; "high": hi·hi + hi·lo + lo·hi, summed
    in that order): the gram in [:k, :k], the rhs in [:k, k]. Padded lanes
    and the tables' zero columns contribute exactly 0 to both."""
    with span("crtpu.als.gather"):
        F = gather_operands(idx, val, tables, b, k, precision)
    with span("crtpu.als.gram"):
        Gaug = gram_product(F[0], F[0])                   # (S, c, c)
        if precision == "high":
            Gaug += gram_product(F[0], F[1])
            Gaug += gram_product(F[1], F[0])
    return Gaug[:, :k, :k], Gaug[:, :k, k]


def _solve_kxk(A: torch.Tensor, r: torch.Tensor, solver: str) -> torch.Tensor:
    if solver == "gj":
        return gj_solve(A, r)                 # K5 on CUDA tensors
    if solver == "gj_xla":
        return gj_solve_plain(A, r)           # the JAX package's XLA path
    C, _ = torch.linalg.cholesky_ex(A)        # no raise: λ=0 pads are masked
    y = torch.linalg.solve_triangular(C, r.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(C.transpose(-1, -2), y,
                                         upper=True)[..., 0]


def _row_bytes(L: int, p: int, k: int, precision: str) -> int:
    """One bucket row's temps of the assembly and solve: the gathered
    operands (L lanes), the augmented grams alive at once (p slots) and
    the p solutions."""
    if precision == "highest":
        return (L * (k + 1) + p * (k + 1) ** 2 + p * k) * 4
    c = _padded_width(k)
    parts = 2 if precision == "high" else 1     # hi and lo; G and a term
    return parts * (L * c * 2 + p * c * c * 4) + p * k * 4


def _row_groups(rows: int, L: int, p: int, k: int,
                group_bytes: int = GROUP_TEMP_BYTES,
                precision: str = "highest") -> list[tuple[int, int]]:
    """Row-contiguous groups of one bucket whose temps (``_row_bytes``)
    fit the budget."""
    g = max(1, min(rows, group_bytes // _row_bytes(L, p, k, precision)))
    return [(r0, min(rows, r0 + g)) for r0 in range(0, rows, g)]


def _solve_side(idx_tiles, val_tiles, side: EllSide, other: torch.Tensor,
                lam: float, slot_nnz: torch.Tensor, solver: str = "gj",
                group_bytes: int = GROUP_TEMP_BYTES,
                precision: str = "highest") -> torch.Tensor:
    """One ALS half-iteration over a side: x_j = (F_Ω^T F_Ω + λI)^{-1}
    F_Ω^T r for every slot, in row groups per bucket (one K5 launch each);
    returns the (n_slots, k) new factors. Profiler spans: the tables and
    each group's gathers are ``crtpu.als.gather``, its gram products
    ``crtpu.als.gram``, its solve and store ``crtpu.als.solve``."""
    k = other.shape[1]
    with span("crtpu.als.gather"):
        tables = gram_tables(other, precision)
    new = other.new_zeros((side.n_slots, k))
    for b, off, idx, val in zip(side.buckets, side.bucket_offsets,
                                idx_tiles, val_tiles):
        for r0, r1 in _row_groups(b.rows, b.L, b.p, k, group_bytes,
                                  precision):
            G, r = _gram_and_rhs(idx[r0:r1], val[r0:r1], tables, b, k,
                                 precision)
            with span("crtpu.als.solve"):
                # λ unscaled, ALS.cpp:121
                G.diagonal(dim1=1, dim2=2).add_(lam)
                new[off + r0 * b.p:off + r1 * b.p] = _solve_kxk(G, r, solver)
    # empty/padding slots -> exact zeros (src/ALS.cpp:151-157), also guards
    # the λ=0 singular-gram case from NaN-poisoning the factor table
    return torch.where((slot_nnz > 0)[:, None], new, 0.0)


def make_als_outer_step(ell: EllPair, lam: float, *, solver: str = "gj",
                        group_bytes: int = GROUP_TEMP_BYTES,
                        gather: Optional[Callable] = None,
                        precision: str = "highest") -> Callable:
    """One outer iteration: the W side from the current H, then the H side
    from the NEW W, the grams at ``precision`` (one of ``PRECISIONS``).
    ``step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c) -> (W, H)``,
    the JAX package's step signature. ``gather`` (the
    sharded step, parallel/als_ell_sharded.py) turns this rank's slot block
    of the other side's factors into the global table (an all-gather);
    ``ell`` is then the rank's shard of the layout."""
    if precision not in PRECISIONS:
        raise ValueError(f"als_precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    rows, cols = ell.rows_side, ell.cols_side

    def table(F):
        return F if gather is None else gather(F)

    def step(idx_r, idx_c, vals_r, vals_c, W, H, nnz_r, nnz_c):
        W = _solve_side(idx_r, vals_r, rows, table(H), lam, nnz_r, solver,
                        group_bytes, precision)
        H = _solve_side(idx_c, vals_c, cols, table(W), lam, nnz_c, solver,
                        group_bytes, precision)
        return W, H

    return step


def side_tensors(side: EllSide, device) -> tuple[tuple, tuple]:
    """A side's bucket tiles on ``device``: (idx int64, val f32) tuples."""
    return (tuple(torch.as_tensor(b.idx.astype(np.int64), device=device)
                  for b in side.buckets),
            tuple(torch.as_tensor(b.val, device=device)
                  for b in side.buckets))


def k5_launches_per_iter(ell: EllPair, k: int, solver: str,
                         group_bytes: int, precision: str = "highest") -> int:
    """K5 launches of one outer iteration: one per (bucket, row group)."""
    if solver != "gj":
        return 0
    return sum(len(_row_groups(b.rows, b.L, b.p, k, group_bytes, precision))
               for side in (ell.rows_side, ell.cols_side)
               for b in side.buckets)


def _side_plan(side: EllSide, floor: int, k: int, group_bytes: int,
               precision: str) -> dict:
    return dict(min_width=floor, widths=[b.E for b in side.buckets],
                rows=[b.rows for b in side.buckets],
                slots=[b.rows * b.p for b in side.buckets],
                n_slots=side.n_slots, padded_lanes=side.nnz_padded,
                groups=[len(_row_groups(b.rows, b.L, b.p, k, group_bytes,
                                        precision))
                        for b in side.buckets])


def _untiled_note(ell: EllPair, k: int, tile_mb: float) -> Optional[str]:
    """The JAX package tiles a side's gathers (gather-cliff tiling) when the
    OTHER side's table exceeds ``tile_mb`` and the side has p == 1
    buckets. The port runs those sides untiled; say so."""
    tile_bytes = int(tile_mb * (1 << 20))
    sides = [f"{name} side ({other.n_slots * k * 4 / 2**20:.1f} MB table)"
             for name, side, other in (("rows", ell.rows_side, ell.cols_side),
                                       ("cols", ell.cols_side, ell.rows_side))
             if tile_bytes and other.n_slots * k * 4 > tile_bytes
             and any(b.p == 1 for b in side.buckets)]
    if not sides:
        return None
    return (f"[info] als_gather_tile_mb={tile_mb:g} would tile the gathers "
            f"of the {' and '.join(sides)}; gather tiling is not in the "
            "port (ROADMAP.md 'Not ported'): running untiled, the same math")


def als_ell_train(R: RatingMatrix, W0: np.ndarray, H0: np.ndarray,
                  T: TestCOO, cfg: Config, *, device="cuda",
                  callback: Optional[Callable[[IterStats], None]] = None,
                  log: Optional[MetricsLog] = None,
                  ckpt_every: int = 0, ckpt_fn=None, resume=None,
                  ) -> tuple[np.ndarray, np.ndarray, list[IterStats]]:
    """Train ALS on the ELL backend on ``device``. W0 (m, k), H0 (n, k)
    entity-major; returns factors in the same layout and order. Every
    ``ckpt_every`` outer iterations ``ckpt_fn(oiter, {"W", "H"})`` gets the
    slot-space factors (solvers/als_state.py);
    ``resume={"oiter", "W", "H"}`` (such a payload after outer iteration
    ``oiter``) continues from it. With ``log``, the layout and the set-up
    times are reported as an info line and an ``als_plan`` event."""
    dev = resolve_device(device)
    k = W0.shape[1]
    precision = cfg.als_precision
    group_bytes = cfg.als_group_mb << 20
    t0 = time.perf_counter()
    ell = build_ell_pair(R, min_width=cfg.als_min_width, num_shards=1)
    rows, cols = ell.rows_side, ell.cols_side
    t1 = time.perf_counter()
    start_oiter = 1
    if resume is not None:
        start_oiter = int(resume["oiter"]) + 1
    W, H = als_state_from_numpy(
        resume if resume is not None else slot_payload(ell, W0, H0), ell, dev)
    idx_r, vals_r = side_tensors(rows, dev)
    idx_c, vals_c = side_tensors(cols, dev)
    nnz_r = torch.as_tensor(rows.slot_nnz, device=dev)
    nnz_c = torch.as_tensor(cols.slot_nnz, device=dev)
    synchronize(dev)
    t2 = time.perf_counter()

    if log is not None:
        plan = {name: _side_plan(
                    side, _resolve_min_width(cfg.als_min_width,
                                             np.diff(ptr)), k, group_bytes,
                    precision)
                for name, side, ptr in (("rows", rows, R.csr_ptr),
                                        ("cols", cols, R.csc_ptr))}
        launches = k5_launches_per_iter(ell, k, cfg.als_solver, group_bytes,
                                        precision)
        log.info("[info] als plan: " + "; ".join(
            f"{name} side {len(p['widths'])} buckets (widths "
            f"{p['widths']}), {p['padded_lanes']} padded lanes, "
            f"{sum(p['groups'])} groups, floor {p['min_width']}"
            for name, p in plan.items())
            + f"; gram precision {precision}; K5 launches per iteration "
            f"{launches}; plan "
            f"{t1 - t0:.3f} s, device set-up {t2 - t1:.3f} s")
        log.event("als_plan", k=k, solver=cfg.als_solver,
                  precision=precision, nnz=R.nnz,
                  sides=plan, k5_launches_per_iter=launches,
                  plan_s=t1 - t0, setup_s=t2 - t1)
        note = _untiled_note(ell, k, cfg.als_gather_tile_mb)
        if note:
            log.info(note)

    step = make_als_outer_step(ell, cfg.lambda_, solver=cfg.als_solver,
                               group_bytes=group_bytes, precision=precision)

    def i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    ti = i64(rows.slot_of_entity[T.row_idx])
    tj = i64(cols.slot_of_entity[T.col_idx])
    tv = torch.as_tensor(np.asarray(T.val, np.float32), device=dev)
    chunk = default_eval_chunk(T.nnz, cfg.eval_chunk)
    box = {"WH": (W, H)}

    def do_step():
        box["WH"] = step(idx_r, idx_c, vals_r, vals_c, *box["WH"], nnz_r,
                         nnz_c)
        return box["WH"][0]

    stats = pipelined_loop(
        start_oiter=start_oiter, maxiter=cfg.maxiter,
        fuse=cfg.fused_outer_iters, do_step=do_step,
        do_rmse=lambda: calrmse_device(ti, tj, tv, *box["WH"],
                                       entity_major=True, chunk=chunk),
        callback=callback, ckpt_every=ckpt_every, ckpt_fn=ckpt_fn,
        get_payload=lambda: als_state_to_numpy(*box["WH"]),
        early_stop_eps=cfg.eps if cfg.early_stop else 0.0)

    W, H = box["WH"]
    return (W.cpu().numpy()[rows.slot_of_entity],
            H.cpu().numpy()[cols.slot_of_entity], stats)
