"""Plain ALS in PyTorch: the benchmark's reference for the ALS cells.

ALS as the reference program runs it (Zialus/CUDA-Recommender
``src/ALS.cpp:81-233``): W (m, k) and H (n, k) entity major; each outer
iteration sets every user's row to the solution of (F^T F + lambda I) x =
F^T r over the item rows F of its ratings r (lambda unscaled on the
diagonal), then every item's row the same way over the NEW user rows; an
entity without ratings gets 0. The test RMSE follows every iteration.

Entities are grouped by degree into power-of-two widths and padded with a
zero row, so that a group's grams are one batched float32 product (TF32
off) and its systems one batched ``torch.linalg.solve``. No plan, no
kernel: it reads only the COO arrays it is given and imports nothing of
the program.

With ``tf32`` it is the ALS configuration's control: the grams' products
take their inputs (the gathered rows and ratings) rounded to TF32's
10-bit mantissa, as tensor cores round them; the solve stays float32.

``step_residual`` judges a step's output by what it says: each entity's
new row x should solve its normal equations G x = b, formed here in
float64 from the step's own inputs; its relative residual ||G x - b|| /
||b|| is the backward error of the step, which the equations' conditioning
does not inflate as it does the forward gap to another float32 solve.
"""

from __future__ import annotations

import torch

from .common import Sorted, rmse, sort_coo, test_pairs

#: bytes of gathered rows and grams a chunk of a width group may take
CHUNK_BYTES = 1 << 30


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa (to nearest, ties
    away from zero), as the tensor cores round a TF32 product's inputs."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _chunks(seg: Sorted, k: int) -> list:
    """The side's entities grouped by degree: for each power-of-two width L,
    the entities of degree in (L/2, L], in chunks of at most CHUNK_BYTES of
    gathered rows and grams, each as (entities, (E, L) other-side ids with
    -1 on padded lanes, (E, L, 1) ratings with 0 on padded lanes)."""
    deg = seg.deg
    col = torch.cat([seg.col, seg.col.new_full((1,), -1)])
    val = torch.cat([seg.val, seg.val.new_zeros(1)])
    out = []
    width = 1
    top = int(deg.max()) if deg.numel() else 0
    while width // 2 < top:
        ents = torch.nonzero((deg > width // 2) & (deg <= width)).flatten()
        step = max(1, CHUNK_BYTES // ((width + k) * k * 4))
        lane = torch.arange(width, device=deg.device)
        for s in range(0, ents.shape[0], step):
            e = ents[s:s + step]
            pos = torch.where(lane < deg[e, None], seg.ptr[e, None] + lane,
                              -1)
            out.append((e, col[pos], val[pos].unsqueeze(2)))
        width *= 2
    return out


def _solve_side(chunks: list, other: torch.Tensor, lam: float,
                entities: int, tf32: bool = False) -> torch.Tensor:
    """New rows of one side from the other side's rows ``other`` (n, k);
    with ``tf32`` the grams' inputs (the rows and ratings) are rounded to
    TF32 first, as a TF32 product rounds them."""
    k = other.shape[1]
    if tf32:
        other = round_tf32(other)
    pad = torch.cat([other, other.new_zeros((1, k))])   # row -1: zeros
    out = torch.zeros((entities, k), dtype=torch.float32, device=other.device)
    eye = lam * torch.eye(k, dtype=torch.float32, device=other.device)
    for ents, idx, r in chunks:
        F = pad[idx]
        if tf32:
            r = round_tf32(r)
        Ft = F.transpose(1, 2)
        G = torch.bmm(Ft, F) + eye
        out[ents] = torch.linalg.solve(G, torch.bmm(Ft, r)).squeeze(2)
    return out


def _sides(rows: int, cols: int, train: tuple, k: int, device) -> tuple:
    """The user side's and the item side's degree-grouped chunks."""
    by_row = sort_coo(train, rows, cols, device)
    by_col = by_row.transposed()
    # in the item-sorted order the other side is the user: swap roles
    by_col = Sorted(row=by_col.col, col=by_col.row, val=by_col.val,
                    ptr=by_col.ptr, deg=by_col.deg)
    return _chunks(by_row, k), _chunks(by_col, k)


def _residuals(chunks: list, other: torch.Tensor, x: torch.Tensor,
               lam: float) -> torch.Tensor:
    """Per entity with ratings: ||G x - b|| / ||b||, G = F^T F + lam I and
    b = F^T r in float64 over the other side's rows F and the ratings r."""
    k = other.shape[1]
    pad = torch.cat([other, other.new_zeros((1, k))]).double()
    eye = lam * torch.eye(k, dtype=torch.float64, device=other.device)
    out = []
    for ents, idx, r in chunks:
        F = pad[idx]
        Ft = F.transpose(1, 2)
        b = torch.bmm(Ft, r.double())
        Gx = torch.bmm(Ft, torch.bmm(F, x[ents].double().unsqueeze(2)))
        Gx += eye @ x[ents].double().unsqueeze(2)
        nb = b.flatten(1).norm(dim=1)
        keep = nb > 0
        out.append(((Gx - b).flatten(1).norm(dim=1)[keep] / nb[keep]))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.float64)


def step_residual(rows: int, cols: int, train: tuple, state: tuple,
                  new: tuple, *, lam: float, device) -> float:
    """The backward error of one ALS outer iteration's output ``new`` =
    (W, H) from ``state`` = (W, H): the new W against the normal
    equations over the state's H, the new H against those over the new W;
    the larger of the two sides' median entity."""
    H_in = torch.as_tensor(state[1], device=device)
    W, H = (torch.as_tensor(x, device=device) for x in new)
    c_row, c_col = _sides(rows, cols, train, W.shape[1], device)
    med = [float(res.median()) for res in (_residuals(c_row, H_in, W, lam),
                                           _residuals(c_col, W, H, lam))
           if res.numel()]
    return max(med) if med else 0.0


def als_train(rows: int, cols: int, train: tuple, test: tuple,
              W0: torch.Tensor, H0: torch.Tensor, *, lam: float, iters: int,
              device, tf32: bool = False) -> dict:
    """``iters`` outer iterations of ALS from W = ``W0`` (rows, k), H =
    ``H0`` (cols, k). ``train`` and ``test`` are (row, col, value) arrays.
    ``tf32``: the grams' inputs rounded to TF32, the nearest precision
    below float32 with TF32 off (the control).
    Returns ``{"rmse": [per iteration], "W", "H": the final factors
    (host)}``."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        c_row, c_col = _sides(rows, cols, train, W0.shape[1], device)
        tst = test_pairs(test, device)
        W = W0.to(device=device, dtype=torch.float32).clone()
        H = H0.to(device=device, dtype=torch.float32).clone()
        out = {"rmse": []}
        for _ in range(iters):
            W = _solve_side(c_row, H, lam, rows, tf32)
            H = _solve_side(c_col, W, lam, cols, tf32)
            out["rmse"].append(rmse(tst, W, H))
        out["W"], out["H"] = W.cpu().numpy(), H.cpu().numpy()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev
