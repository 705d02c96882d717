"""Training state of the pure-ELL CCD++ backend, and its exchange with the
JAX package.

``EllState`` is what one outer step reads and updates in place: both
orientations' ELL residual value tiles (the reference's dual R/Rt residual
storage, cuda_src/CCD_CUDA.cu:300-316), the factors in SLOT space (data/
ell.py: entities renamed bucket-major) and the pending outer product (the
deferred subtract of the last rank, reference src/CCD.cpp:100-134).

``ell_state_from_numpy`` / ``ell_state_to_numpy`` convert it to and from
the JAX package's checkpoint payload (keys ``W``, ``H``, ``u_pend``,
``v_pend``, ``vals_r_i``, ``vals_c_i``; ``cuda_recommender_tpu/solvers/
ccd_ell.py::ccd_ell_train``), so a state written by either package resumes
in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data.ell import EllPair
from .hybrid_state import _to_torch


@dataclasses.dataclass
class EllState:
    vals_r: list           # rows-side ELL residual value tiles (rows, L) f32
    vals_c: list           # cols-side ELL residual value tiles
    W: torch.Tensor        # (k, rows.n_slots) f32, slot space
    H: torch.Tensor        # (k, cols.n_slots) f32
    u_pend: torch.Tensor   # (rows.n_slots,) f32 — last rank's new u
    v_pend: torch.Tensor   # (cols.n_slots,) f32


def factors_to_slots(F: np.ndarray, side) -> np.ndarray:
    """(k, n_entities) entity order -> (k, n_slots) slot space (padding
    slots zero)."""
    out = np.zeros((F.shape[0], side.n_slots), dtype=np.float32)
    out[:, side.slot_of_entity] = F
    return out


def ell_state_from_numpy(payload: dict, ell: EllPair, device) -> EllState:
    """A payload (numpy arrays under the JAX checkpoint keys) as a port
    ``EllState`` on ``device``. Raises ValueError if a shape does not fit
    the layout (a payload of another layout would map onto wrong slots)."""
    rows, cols = ell.rows_side, ell.cols_side
    f32 = {key: np.asarray(payload[key], np.float32)
           for key in ("W", "H", "u_pend", "v_pend")}
    want = {"W": (f32["W"].shape[0], rows.n_slots),
            "H": (f32["W"].shape[0], cols.n_slots),
            "u_pend": (rows.n_slots,), "v_pend": (cols.n_slots,)}
    for i, b in enumerate(rows.buckets):
        want[f"vals_r_{i}"] = b.val.shape
    for i, b in enumerate(cols.buckets):
        want[f"vals_c_{i}"] = b.val.shape
    bad = [f"{key} {np.shape(payload[key])} (want {want[key]})"
           for key in want if np.shape(payload[key]) != want[key]]
    if bad:
        raise ValueError("payload does not fit this layout: "
                         + ", ".join(bad))
    return EllState(
        vals_r=[_to_torch(np.asarray(payload[f"vals_r_{i}"], np.float32),
                          device) for i in range(len(rows.buckets))],
        vals_c=[_to_torch(np.asarray(payload[f"vals_c_{i}"], np.float32),
                          device) for i in range(len(cols.buckets))],
        **{key: _to_torch(x, device) for key, x in f32.items()})


def ell_state_to_numpy(state: EllState) -> dict:
    """The port's state as a JAX-package payload of numpy arrays."""
    def host(x):
        return x.detach().to("cpu", copy=True).numpy()

    payload = {"W": host(state.W), "H": host(state.H),
               "u_pend": host(state.u_pend), "v_pend": host(state.v_pend)}
    for i, v in enumerate(state.vals_r):
        payload[f"vals_r_{i}"] = host(v)
    for i, v in enumerate(state.vals_c):
        payload[f"vals_c_{i}"] = host(v)
    return payload


def ell_payload_block(payload: dict, ell: EllPair, shard: int) -> dict:
    """The block of a global payload of a shard-uniform layout (``ell``
    built with ``num_shards`` N, as the JAX package's sharded run stores
    it) that rank ``shard`` holds: its slot block of the factors and the
    pending vectors, its rows of each bucket's value tile."""
    rows, cols = ell.rows_side, ell.cols_side
    sr = slice(shard * rows.slots_per_shard,
               (shard + 1) * rows.slots_per_shard)
    sc = slice(shard * cols.slots_per_shard,
               (shard + 1) * cols.slots_per_shard)
    out = {"W": np.asarray(payload["W"])[:, sr],
           "H": np.asarray(payload["H"])[:, sc],
           "u_pend": np.asarray(payload["u_pend"])[sr],
           "v_pend": np.asarray(payload["v_pend"])[sc]}
    for key, side in (("vals_r", rows), ("vals_c", cols)):
        for i, b in enumerate(side.buckets):
            r = b.rows_per_shard
            out[f"{key}_{i}"] = np.asarray(
                payload[f"{key}_{i}"])[shard * r:(shard + 1) * r]
    return out


def ell_payload_assemble(parts: dict) -> dict:
    """The global payload from every rank's block payload (``parts``: key
    -> list in rank order = shard-major slot order)."""
    return {key: np.concatenate(blocks, axis=1 if key in ("W", "H") else 0)
            for key, blocks in parts.items()}
