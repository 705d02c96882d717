"""Training state of the ALS backend, and its exchange with the JAX package.

ALS carries nothing across outer iterations but the factors. In training
they live in SLOT space (data/ell.py: entities renamed bucket-major, so
per-bucket solves concatenate): W (rows.n_slots, k) and H (cols.n_slots, k),
float32, with zero rows for the padding slots. That is the JAX package's
checkpoint payload too (keys ``W``, ``H``;
``cuda_recommender_tpu/solvers/als_ell.py::als_ell_train``), so a state
written by either package resumes in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.ell import EllPair


def slot_payload(ell: EllPair, W0: np.ndarray, H0: np.ndarray) -> dict:
    """Entity-major factors W0 (m, k), H0 (n, k) as a slot-space payload
    (padding slots zero)."""
    k = W0.shape[1]
    W = np.zeros((ell.rows_side.n_slots, k), np.float32)
    W[ell.rows_side.slot_of_entity] = np.asarray(W0, np.float32)
    H = np.zeros((ell.cols_side.n_slots, k), np.float32)
    H[ell.cols_side.slot_of_entity] = np.asarray(H0, np.float32)
    return {"W": W, "H": H}


def als_state_from_numpy(payload: dict, ell: EllPair, device):
    """A slot-space payload ({"W", "H"} numpy arrays) as (W, H) float32
    tensors on ``device``. Raises ValueError if the shapes do not fit the
    layout (a payload of another layout would map onto wrong slots)."""
    W = np.asarray(payload["W"], np.float32)
    H = np.asarray(payload["H"], np.float32)
    want = (ell.rows_side.n_slots, ell.cols_side.n_slots)
    if W.ndim != 2 or H.ndim != 2 or (W.shape[0], H.shape[0]) != want \
            or W.shape[1] != H.shape[1]:
        raise ValueError(f"payload W {W.shape}, H {H.shape} does not fit "
                         f"this layout's ({want[0]}, k), ({want[1]}, k) slots")
    return (torch.from_numpy(np.ascontiguousarray(W)).to(device, copy=True),
            torch.from_numpy(np.ascontiguousarray(H)).to(device, copy=True))


def als_state_to_numpy(W: torch.Tensor, H: torch.Tensor) -> dict:
    """The slot-space factors as a JAX-package payload of numpy arrays."""
    return {"W": W.detach().to("cpu", copy=True).numpy(),
            "H": H.detach().to("cpu", copy=True).numpy()}


def als_payload_block(payload: dict, ell: EllPair, shard: int) -> dict:
    """Rank ``shard``'s slot block of a global payload of a shard-uniform
    layout (``ell`` built with ``num_shards`` N)."""
    out = {}
    for key, side in (("W", ell.rows_side), ("H", ell.cols_side)):
        s = side.slots_per_shard
        out[key] = np.asarray(payload[key])[shard * s:(shard + 1) * s]
    return out
