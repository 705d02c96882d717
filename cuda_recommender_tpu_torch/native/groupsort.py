"""Grouping primitives over small integer keys: the native OpenMP counting
sort (src/groupsort.cpp), or the NumPy paths of data/groupsort.py.

The port of ``cuda_recommender_tpu/native/groupsort.py``. Every entry point
is an exact drop-in for its NumPy equivalent -- ``key_count ==
np.bincount(keys, minlength=nkeys)``, ``stable_perm == np.argsort(keys,
kind="stable")`` and ``perm_gather == (idx[perm], val[perm])`` -- so the
callers (data/sparse.py::from_coo, solvers/ccd_hybrid.py's planner) stay
single-path and produce byte-identical results either way.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..data import groupsort as numpy_path
from . import available, lib, record

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)

#: below this, ctypes call overhead beats any parallel win
_NATIVE_MIN = 1 << 16


def _keys32(keys: np.ndarray) -> np.ndarray:
    k = np.ascontiguousarray(keys)
    return k if k.dtype == np.int32 else k.astype(np.int32)


def _native(size: int) -> bool:
    """Whether a call over ``size`` keys takes the native path; records
    the path."""
    native = size >= _NATIVE_MIN and available()
    record("groupsort", "native" if native else "numpy")
    return native


def key_count(keys: np.ndarray, nkeys: int) -> np.ndarray:
    """Histogram of ``keys`` (all in [0, nkeys)) as int64, shape (nkeys,)."""
    if _native(keys.size):
        k = _keys32(keys)
        counts = np.empty(nkeys, np.int64)
        lib().crtpu_key_count(k.ctypes.data_as(_I32), k.size,
                              np.int64(nkeys), counts.ctypes.data_as(_I64))
        return counts
    return numpy_path.key_count(keys, nkeys)


def stable_perm(keys: np.ndarray, nkeys: int
                ) -> tuple[np.ndarray, np.ndarray]:
    """Stable counting-sort permutation of ``keys`` (all in [0, nkeys)).

    Returns ``(ptr, perm)``: group k occupies ``perm[ptr[k]:ptr[k+1]]`` in
    input order; ``keys[perm]`` is sorted ascending with ties in input
    order (== ``np.argsort(keys, kind="stable")``).
    """
    if _native(keys.size):
        k = _keys32(keys)
        ptr = np.empty(nkeys + 1, np.int64)
        perm = np.empty(k.size, np.int64)
        lib().crtpu_stable_perm(k.ctypes.data_as(_I32), k.size,
                                np.int64(nkeys), ptr.ctypes.data_as(_I64),
                                perm.ctypes.data_as(_I64))
        return ptr, perm
    return numpy_path.stable_perm(keys, nkeys)


def perm_gather(perm: np.ndarray, idx: np.ndarray, val: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
    """``(idx[perm].astype(int32), val[perm])`` in one parallel pass."""
    if idx.dtype == np.int32 and val.dtype == np.float32 \
            and _native(perm.size):
        p = np.ascontiguousarray(perm, np.int64)
        ic = np.ascontiguousarray(idx)
        vc = np.ascontiguousarray(val)
        out_i = np.empty(p.size, np.int32)
        out_v = np.empty(p.size, np.float32)
        lib().crtpu_perm_gather(p.ctypes.data_as(_I64), p.size,
                                ic.ctypes.data_as(_I32),
                                vc.ctypes.data_as(_F32),
                                out_i.ctypes.data_as(_I32),
                                out_v.ctypes.data_as(_F32))
        return out_i, out_v
    return numpy_path.perm_gather(perm, idx, val)
