"""Reference-compatible on-disk formats (NumPy).

The port's copy of ``cuda_recommender_tpu/data/binfmt.py``: the same
readers and writers, so both packages write byte-identical files and read
each other's. Byte-level parity with the reference's loaders, so
preconverted datasets and models interchange directly:

* ``meta_modified_all`` packed binary dataset (load(),
  reference src/tools.cpp:3-85; readers at src/pmf_util.h:38-81,171-193):
  text manifest ``m n nnz`` + 9 filenames (COO val/row/col + CSR
  rowptr/colidx/val + CSC colptr/rowidx/val) + ``nnz_test`` + 3 test filenames
  (val/row/col). Binary payloads: ptr arrays int32, index arrays uint32,
  value arrays float32.
* ``meta`` text manifest (generate_file_pointers,
  reference src/extras.cpp:24-44): ``m n`` / ``nnz train_file`` /
  ``nnz_test test_file``, with whitespace ``row col val`` rating lines
  (1-based in the reference's predict path, src/extras.cpp:166-168).
* model files (save_mat_t/load_mat_t, reference src/tools.cpp:90-153):
  ``(int64 m, int64 n)`` header + float32 payload per matrix, W then H
  appended to one file; the payload is entity-major for both solvers (the
  col-major branch transposes rank-major CCD factors on write).
"""

from __future__ import annotations

import os

import numpy as np

from .sparse import RatingMatrix, TestCOO, from_coo, make_test

_TRAIN_FILES = ("coo_val.bin", "coo_row.bin", "coo_col.bin",
                "csr_row_ptr.bin", "csr_col_idx.bin", "csr_val.bin",
                "csc_col_ptr.bin", "csc_row_idx.bin", "csc_val.bin")
_TEST_FILES = ("test_val.bin", "test_row.bin", "test_col.bin")


def write_binary_dataset(dirname: str, R: RatingMatrix, T: TestCOO) -> None:
    """Write the full meta_modified_all layout the reference consumes."""
    os.makedirs(dirname, exist_ok=True)
    r, c, v = R.to_coo()
    payloads = {
        "coo_val.bin": v.astype("<f4"),
        "coo_row.bin": r.astype("<u4"),
        "coo_col.bin": c.astype("<u4"),
        "csr_row_ptr.bin": R.csr_ptr.astype("<i4"),
        "csr_col_idx.bin": R.csr_idx.astype("<u4"),
        "csr_val.bin": R.csr_val.astype("<f4"),
        "csc_col_ptr.bin": R.csc_ptr.astype("<i4"),
        "csc_row_idx.bin": R.csc_idx.astype("<u4"),
        "csc_val.bin": R.csc_val.astype("<f4"),
        "test_val.bin": T.val.astype("<f4"),
        "test_row.bin": T.row_idx.astype("<u4"),
        "test_col.bin": T.col_idx.astype("<u4"),
    }
    for name, arr in payloads.items():
        arr.tofile(os.path.join(dirname, name))
    with open(os.path.join(dirname, "meta_modified_all"), "w") as f:
        f.write(f"{R.rows} {R.cols} {R.nnz}\n")
        for name in _TRAIN_FILES:
            f.write(name + "\n")
        f.write(f"{T.nnz}\n")
        for name in _TEST_FILES:
            f.write(name + "\n")


def load_binary_dataset(dirname: str) -> tuple[RatingMatrix, TestCOO]:
    """Load a meta_modified_all dataset dir (reference load(), tools.cpp:3-85).
    Like the reference, only the CSR/CSC train payloads and the COO test
    payloads are consumed (the train COO files are listed but unused)."""
    meta = os.path.join(dirname, "meta_modified_all")
    with open(meta) as f:
        tokens = f.read().split()
    m, n, nnz = int(tokens[0]), int(tokens[1]), int(tokens[2])
    names = tokens[3:12]
    nnz_test = int(tokens[12])
    test_names = tokens[13:16]
    def p(name):
        return os.path.join(dirname, name)

    csr_ptr = np.fromfile(p(names[3]), dtype="<i4", count=m + 1).astype(np.int64)
    csr_idx = np.fromfile(p(names[4]), dtype="<u4", count=nnz).astype(np.int32)
    csr_val = np.fromfile(p(names[5]), dtype="<f4", count=nnz)
    csc_ptr = np.fromfile(p(names[6]), dtype="<i4", count=n + 1).astype(np.int64)
    csc_idx = np.fromfile(p(names[7]), dtype="<u4", count=nnz).astype(np.int32)
    csc_val = np.fromfile(p(names[8]), dtype="<f4", count=nnz)
    for arr, want in ((csr_ptr, m + 1), (csr_idx, nnz), (csr_val, nnz),
                      (csc_ptr, n + 1), (csc_idx, nnz), (csc_val, nnz)):
        if arr.shape[0] != want:
            raise ValueError(f"short read in {dirname}: got {arr.shape[0]}, "
                             f"want {want}")
    R = RatingMatrix(m, n, csr_ptr, csr_idx, csr_val, csc_ptr, csc_idx, csc_val)

    tv = np.fromfile(p(test_names[0]), dtype="<f4", count=nnz_test)
    tr = np.fromfile(p(test_names[1]), dtype="<u4", count=nnz_test)
    tc = np.fromfile(p(test_names[2]), dtype="<u4", count=nnz_test)
    T = make_test(m, n, tr.astype(np.int64), tc.astype(np.int64), tv)
    return R, T


def load_meta_text_dataset(dirname: str) -> tuple[RatingMatrix, TestCOO]:
    """Load the legacy ``meta`` text layout (extras.cpp:24-44 +
    TestData::read at pmf_util.h:155-168): whitespace `row col val` triples,
    1-based ids (the reference's predict path indexes W[i-1])."""
    with open(os.path.join(dirname, "meta")) as f:
        m, n = map(int, f.readline().split())
        nnz_s, train_name = f.readline().split()
        nnz_test_s, test_name = f.readline().split()

    def read_triples(path, count):
        data = np.loadtxt(path, usecols=(0, 1, 2), dtype=np.float64,
                          ndmin=2, max_rows=count)
        return (data[:, 0].astype(np.int64) - 1,
                data[:, 1].astype(np.int64) - 1,
                data[:, 2].astype(np.float32))

    r, c, v = read_triples(os.path.join(dirname, train_name), int(nnz_s))
    R = from_coo(m, n, r, c, v)
    tr, tc, tv = read_triples(os.path.join(dirname, test_name), int(nnz_test_s))
    return R, make_test(m, n, tr, tc, tv)


def save_model(path: str, W: np.ndarray, H: np.ndarray, *,
               entity_major: bool) -> None:
    """save_mat_t(W)+save_mat_t(H) parity (tools.cpp:90-119): per matrix an
    (int64 rows, int64 cols) header then float32 payload, entity-major (the
    reference's col-major branch transposes CCD's rank-major factors)."""
    with open(path, "wb") as f:
        for A in (W, H):
            Ae = np.asarray(A, dtype=np.float32)
            if not entity_major:
                Ae = Ae.T                         # (k, n) -> (n, k)
            np.asarray(Ae.shape, dtype="<i8").tofile(f)
            np.ascontiguousarray(Ae).tofile(f)


def load_model(path: str, *, entity_major: bool = True
               ) -> tuple[np.ndarray, np.ndarray]:
    """load_mat_t x2 (tools.cpp:121-153). Returns (W, H), entity-major by
    default (set entity_major=False for CCD's rank-major layout)."""
    out = []
    with open(path, "rb") as f:
        for _ in range(2):
            hdr = np.fromfile(f, dtype="<i8", count=2)
            if hdr.shape[0] != 2:
                raise ValueError(f"truncated model file {path}")
            rows, cols = int(hdr[0]), int(hdr[1])
            A = np.fromfile(f, dtype="<f4", count=rows * cols)
            if A.shape[0] != rows * cols:
                raise ValueError(f"truncated model payload in {path}")
            out.append(A.reshape(rows, cols))
    W, H = out
    if not entity_major:
        W, H = np.ascontiguousarray(W.T), np.ascontiguousarray(H.T)
    return W, H
