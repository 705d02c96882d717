"""Plain CCD++ in PyTorch: the benchmark's reference for the CCD++ cells.

CCD++ as the reference program runs it (Zialus/CUDA-Recommender
``src/CCD.cpp:45-163``; Yu et al., ICDM 2012): W (k, m) and H (k, n) rank
major, H zero at entry; for each rank t, from outer iteration 2 on, the
rank's outer product is added back to the residual; ``inner`` times, every
item's v is set to g / (lambda * deg + h) with g and h the sums of
residual * u and u^2 over its ratings, then every user's u the same way
over v; an entity without ratings gets 0; then the new outer product is
subtracted. The test RMSE follows every outer iteration.

No layout, no plan, no kernel: one float32 residual in user-sorted order,
a permutation to item-sorted order, and per-entity sums taken as
differences of a float64 cumulative sum. It reads only the COO arrays it
is given and imports nothing of the program.
"""

from __future__ import annotations

import torch

from .common import rmse, segment_sums, sort_coo, test_pairs


def _solve(g: torch.Tensor, h: torch.Tensor, lam: float,
           deg: torch.Tensor) -> torch.Tensor:
    """new[j] = g_j / (lam * deg_j + h_j); 0 where deg_j = 0."""
    den = lam * deg + h
    return torch.where(deg > 0, g / torch.where(deg > 0, den, 1.0),
                       0.0).to(torch.float32)


def ccd_train(rows: int, cols: int, train: tuple, test: tuple,
              W0: torch.Tensor, *, lam: float, inner: int, iters: int,
              device, keep=()) -> dict:
    """``iters`` outer iterations of CCD++ from W = ``W0`` (k, rows), H = 0.
    ``train`` and ``test`` are (row, col, value) arrays. Returns
    ``{"rmse": [per iteration], "W", "H": the final factors (host),
    "kept": {iteration: (W, H)} for each iteration in ``keep``}``."""
    by_row = sort_coo(train, rows, cols, device)        # user-sorted
    by_col = by_row.transposed()                        # item-sorted
    r_idx, c_idx = by_row.row, by_row.col
    rows_c, perm = by_col.row, by_col.perm          # item-sorted order
    res = by_row.val.clone()
    W = W0.to(device=device, dtype=torch.float32).clone()
    k = W.shape[0]
    H = torch.zeros((k, cols), dtype=torch.float32, device=device)
    row_deg = by_row.deg.to(torch.float64)
    col_deg = by_col.deg.to(torch.float64)
    lam64 = float(lam)
    tst = test_pairs(test, device)
    out = {"rmse": [], "kept": {}}
    for oiter in range(1, iters + 1):
        for t in range(k):
            u, v = W[t], H[t]
            ur = u[r_idx]
            if oiter > 1:
                res.addcmul_(ur, v[c_idx])
            for _ in range(inner):
                v = _solve(segment_sums((res * ur)[perm], by_col.ptr),
                           segment_sums(u.square()[rows_c], by_col.ptr),
                           lam64, col_deg)
                vc = v[c_idx]
                u = _solve(segment_sums(res * vc, by_row.ptr),
                           segment_sums(vc * vc, by_row.ptr), lam64, row_deg)
                ur = u[r_idx]
            W[t], H[t] = u, v
            res.addcmul_(ur, vc, value=-1.0)
        out["rmse"].append(rmse(tst, W.t(), H.t()))
        if oiter in keep:
            out["kept"][oiter] = (W.cpu().numpy(), H.cpu().numpy())
    out["W"], out["H"] = W.cpu().numpy(), H.cpu().numpy()
    return out
