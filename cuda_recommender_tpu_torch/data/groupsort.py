"""Grouping primitives over small integer keys (NumPy).

The port's copy of the NumPy paths of ``cuda_recommender_tpu/native/
groupsort.py``: ``key_count == np.bincount(keys, minlength=nkeys)`` and
``stable_perm == np.argsort(keys, kind="stable")``, byte for byte, so the
dual CSR+CSC build and the hybrid panel split match the JAX package. The
callers reach them through native/groupsort.py, which takes the OpenMP C++
counting sort instead when the library is available.

``stable_perm`` sorts by 16-bit digits: NumPy's stable sort is a radix sort
for 16-bit keys and a timsort for wider ones, and two stable radix passes
(low digit, then high digit) give the same permutation as one stable sort
on the full key in linear time.
"""

from __future__ import annotations

import numpy as np


def key_count(keys: np.ndarray, nkeys: int) -> np.ndarray:
    """Histogram of ``keys`` (all in [0, nkeys)) as int64, shape (nkeys,)."""
    return np.bincount(keys, minlength=nkeys).astype(np.int64)


def stable_perm(keys: np.ndarray, nkeys: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Stable counting-sort permutation of ``keys`` (all in [0, nkeys)).

    Returns ``(ptr, perm)``: group k occupies ``perm[ptr[k]:ptr[k+1]]`` in
    input order; ``keys[perm]`` is sorted ascending with ties in input
    order (== ``np.argsort(keys, kind="stable")``).
    """
    keys = np.asarray(keys)
    counts = key_count(keys, nkeys)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    if nkeys <= 1 << 16:
        perm = np.argsort(keys.astype(np.uint16), kind="stable")
    elif nkeys <= 1 << 32:
        k = keys.astype(np.int64)
        perm = np.argsort((k & 0xFFFF).astype(np.uint16), kind="stable")
        hi = (k >> 16).astype(np.uint16)[perm]
        perm = perm[np.argsort(hi, kind="stable")]
    else:
        perm = np.argsort(keys, kind="stable")
    return ptr, perm.astype(np.int64)


def perm_gather(perm: np.ndarray, idx: np.ndarray, val: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """``(idx[perm].astype(int32), val[perm])``."""
    return idx[perm].astype(np.int32), val[perm]
