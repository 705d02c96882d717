"""ctypes wrapper for the native ELL bucket fill (src/ellfill.cpp); the port
of ``cuda_recommender_tpu/native/ellfill.py``. Its caller,
data/ell.py::_fill_side, keeps the vectorized NumPy fill for a host with no
toolchain."""

from __future__ import annotations

import ctypes

import numpy as np

from . import lib

_I64 = ctypes.POINTER(ctypes.c_int64)
_I32 = ctypes.POINTER(ctypes.c_int32)
_F32 = ctypes.POINTER(ctypes.c_float)


def fill_bucket(ptr: np.ndarray, nbr_idx: np.ndarray, nbr_val: np.ndarray,
                other_slot: np.ndarray, grid: np.ndarray,
                E: int, p: int, rows_per_shard: int, L_lanes: int,
                zero_slot: int, out_idx: np.ndarray, out_val: np.ndarray
                ) -> None:
    """Fill one bucket's (rows, L) idx/val tiles in place: every lane of
    every slot, the pad lanes with ``zero_slot`` and 0. Raises ValueError
    unless the arrays are C-contiguous with data/ell.py's dtypes and the
    tiles hold ``grid``'s slots."""
    num_shards, slots_ps = grid.shape
    arrays = ((ptr, np.int64), (nbr_idx, np.int32), (nbr_val, np.float32),
              (other_slot, np.int32), (grid, np.int64), (out_idx, np.int32),
              (out_val, np.float32))
    if not all(a.dtype == t and a.flags.c_contiguous for a, t in arrays):
        raise ValueError("fill_bucket: arrays must be C-contiguous with "
                         "data/ell.py's dtypes")
    if out_idx.shape != (num_shards * rows_per_shard, L_lanes) \
            or out_val.shape != out_idx.shape or L_lanes != E * p \
            or slots_ps > rows_per_shard * p:
        raise ValueError(f"fill_bucket: tiles {out_idx.shape} do not hold "
                         f"{num_shards} x {slots_ps} slots of {p} x {E} "
                         "lanes")
    lib().crtpu_ell_fill(
        ptr.ctypes.data_as(_I64), nbr_idx.ctypes.data_as(_I32),
        nbr_val.ctypes.data_as(_F32), other_slot.ctypes.data_as(_I32),
        grid.ctypes.data_as(_I64),
        num_shards, slots_ps, E, p, rows_per_shard, L_lanes,
        np.int32(zero_slot),
        out_idx.ctypes.data_as(_I32), out_val.ctypes.data_as(_F32))
