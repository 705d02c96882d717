"""ctypes wrapper for the native text-ratings parser (src/textparse.cpp);
the port of ``cuda_recommender_tpu/native/textparse.py``."""

from __future__ import annotations

import ctypes

import numpy as np

from . import lib


def load_text_ratings(path: str, *, one_based: bool = True
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native-speed equivalent of data.datasets.load_text_ratings (lines
    with fewer than three numeric fields are skipped). Raises OSError when
    the library or the file is unavailable."""
    L = lib()
    n_cap = L.crtpu_count_lines(path.encode())
    if n_cap < 0:
        raise OSError(f"cannot read {path}")
    rows = np.empty(n_cap, np.int64)
    cols = np.empty(n_cap, np.int64)
    vals = np.empty(n_cap, np.float32)
    n = L.crtpu_parse_ratings(
        path.encode(), int(one_based), n_cap,
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if n < 0:
        raise OSError(f"parse failed for {path}")
    return rows[:n], cols[:n], vals[:n]
