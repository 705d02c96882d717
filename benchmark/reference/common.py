"""What the plain references share: sorting COO ratings by entity on the
device, per-entity sums, and the test RMSE."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

#: test pairs a chunk of the RMSE
RMSE_CHUNK = 1 << 22


@dataclasses.dataclass
class Sorted:
    """Ratings sorted by one side's entity (stable): the entity of each
    rating (``row``), the other side's (``col``), the values, the segment
    pointers and degrees of the sorted side, and ``perm``, the position in
    the parent order of each rating (None for the parent itself)."""

    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    ptr: torch.Tensor
    deg: torch.Tensor
    perm: Optional[torch.Tensor] = None
    cols: int = 0

    def transposed(self) -> "Sorted":
        """The same ratings sorted by the other side, ``perm`` into this
        order; ``row`` is then the other side's entity."""
        perm = torch.sort(self.col, stable=True).indices
        col = self.col[perm]
        deg = torch.bincount(col, minlength=self.cols)
        return Sorted(row=self.row[perm], col=col, val=self.val[perm],
                      ptr=_ptr(deg), deg=deg, perm=perm, cols=self.cols)


def _ptr(deg: torch.Tensor) -> torch.Tensor:
    ptr = torch.zeros(deg.shape[0] + 1, dtype=torch.int64, device=deg.device)
    torch.cumsum(deg, 0, out=ptr[1:])
    return ptr


def sort_coo(coo: tuple, rows: int, cols: int, device) -> Sorted:
    """(row, col, value) host arrays, sorted by row on ``device``."""
    r = torch.as_tensor(coo[0], device=device).to(torch.int64)
    c = torch.as_tensor(coo[1], device=device).to(torch.int64)
    v = torch.as_tensor(coo[2], device=device).to(torch.float32)
    order = torch.sort(r, stable=True).indices
    r, c, v = r[order], c[order], v[order]
    deg = torch.bincount(r, minlength=rows)
    return Sorted(row=r, col=c, val=v, ptr=_ptr(deg), deg=deg, cols=cols)


def segment_sums(x: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    """float64 sums of ``x`` over the segments [ptr[j], ptr[j+1])."""
    c = torch.zeros(x.shape[0] + 1, dtype=torch.float64, device=x.device)
    torch.cumsum(x, 0, dtype=torch.float64, out=c[1:])
    return c[ptr[1:]] - c[ptr[:-1]]


def test_pairs(test: tuple, device) -> tuple:
    """(row, col, value) host arrays as int64, int64, float64 tensors."""
    return (torch.as_tensor(test[0], device=device).to(torch.int64),
            torch.as_tensor(test[1], device=device).to(torch.int64),
            torch.as_tensor(test[2], device=device).to(torch.float64))


def rmse(test: tuple, W: torch.Tensor, H: torch.Tensor) -> float:
    """Test RMSE of entity-major factors W (m, k), H (n, k) over
    ``test_pairs``, in float64."""
    ti, tj, tv = test
    device = W.device
    acc = torch.zeros((), dtype=torch.float64, device=device)
    for s in range(0, tv.shape[0], RMSE_CHUNK):
        e = slice(s, s + RMSE_CHUNK)
        pred = (W[ti[e]].double() * H[tj[e]].double()).sum(dim=1)
        acc += ((pred - tv[e]) ** 2).sum()
    return float(torch.sqrt(acc / max(1, tv.shape[0])))
