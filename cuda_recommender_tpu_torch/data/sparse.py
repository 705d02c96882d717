"""Host-side sparse rating containers (NumPy).

A copy of ``cuda_recommender_tpu/data/sparse.py`` with its semantics
unchanged (the port cannot import the JAX package, whose package import
pulls in jax). Plays the role of the reference's dual CSR+CSC ``SparseMatrix``
(reference src/pmf_util.h:34-149) and COO ``TestData``
(reference src/pmf_util.h:151-211), rebuilt as immutable NumPy builders.
Like the reference, both compressed orientations of the training matrix are kept
(the CCD++ residual is maintained in both orders), and ``transpose()`` is the
zero-copy pointer swap of ``get_shallow_transpose`` (src/pmf_util.h:66-81).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class RatingMatrix:
    """Dual-format (CSR + CSC) sparse rating matrix, host-side."""

    rows: int
    cols: int
    # CSR
    csr_ptr: np.ndarray    # (rows+1,) int64
    csr_idx: np.ndarray    # (nnz,)   int32 column ids
    csr_val: np.ndarray    # (nnz,)   float32
    # CSC
    csc_ptr: np.ndarray    # (cols+1,) int64
    csc_idx: np.ndarray    # (nnz,)   int32 row ids
    csc_val: np.ndarray    # (nnz,)   float32

    @property
    def nnz(self) -> int:
        return int(self.csr_idx.shape[0])

    @property
    def row_nnz(self) -> np.ndarray:
        return np.diff(self.csr_ptr).astype(np.int64)

    @property
    def col_nnz(self) -> np.ndarray:
        return np.diff(self.csc_ptr).astype(np.int64)

    @property
    def max_row_nnz(self) -> int:
        return int(self.row_nnz.max(initial=0))

    @property
    def max_col_nnz(self) -> int:
        return int(self.col_nnz.max(initial=0))

    def transpose(self) -> "RatingMatrix":
        """Zero-copy transpose view (reference get_shallow_transpose)."""
        return RatingMatrix(
            rows=self.cols, cols=self.rows,
            csr_ptr=self.csc_ptr, csr_idx=self.csc_idx, csr_val=self.csc_val,
            csc_ptr=self.csr_ptr, csc_idx=self.csr_idx, csc_val=self.csr_val,
        )

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.rows, self.cols), dtype=np.float32)
        r = np.repeat(np.arange(self.rows), np.diff(self.csr_ptr))
        out[r, self.csr_idx] = self.csr_val
        return out

    def to_coo(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        r = np.repeat(np.arange(self.rows, dtype=np.int32), np.diff(self.csr_ptr))
        return r, self.csr_idx.copy(), self.csr_val.copy()


def from_coo(rows: int, cols: int, row_idx, col_idx, val) -> RatingMatrix:
    """Build dual CSR+CSC from COO triples (duplicates not merged, like the
    ref). Stable by construction: column order within a row (and row order
    within a column) is the COO input order. The grouping runs through the
    native OpenMP counting sort when available, NumPy otherwise
    (data/groupsort.py) -- byte-identical either way
    (native/groupsort.py)."""
    from ..native.groupsort import perm_gather, stable_perm

    row_idx = np.ascontiguousarray(row_idx, dtype=np.int32)
    col_idx = np.ascontiguousarray(col_idx, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float32)
    if not (row_idx.shape == col_idx.shape == val.shape):
        raise ValueError("COO arrays must have matching shapes")
    if row_idx.size and (row_idx.min() < 0 or row_idx.max() >= rows):
        raise ValueError("row index out of range")
    if col_idx.size and (col_idx.min() < 0 or col_idx.max() >= cols):
        raise ValueError("col index out of range")

    csr_ptr, order_r = stable_perm(row_idx, rows)
    csr_idx, csr_val = perm_gather(order_r, col_idx, val)
    csc_ptr, order_c = stable_perm(col_idx, cols)
    csc_idx, csc_val = perm_gather(order_c, row_idx, val)

    return RatingMatrix(rows, cols, csr_ptr, csr_idx, csr_val,
                        csc_ptr, csc_idx, csc_val)


def from_csr(rows: int, cols: int, csr_ptr, csr_idx, csr_val) -> RatingMatrix:
    csr_ptr = np.asarray(csr_ptr, dtype=np.int64)
    r = np.repeat(np.arange(rows, dtype=np.int64), np.diff(csr_ptr))
    return from_coo(rows, cols, r, np.asarray(csr_idx), np.asarray(csr_val))


@dataclasses.dataclass(frozen=True)
class TestCOO:
    """Held-out ratings, COO triples (reference TestData)."""

    rows: int
    cols: int
    row_idx: np.ndarray   # (nnz,) int32
    col_idx: np.ndarray   # (nnz,) int32
    val: np.ndarray       # (nnz,) float32

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])


def make_test(rows: int, cols: int, row_idx, col_idx, val) -> TestCOO:
    return TestCOO(rows, cols,
                   np.asarray(row_idx, dtype=np.int32),
                   np.asarray(col_idx, dtype=np.int32),
                   np.asarray(val, dtype=np.float32))
