"""Training state of the dense and pallas backends, and its exchange with the
JAX package.

``DenseState`` is what one outer step reads and updates in place: the
(m, n) residual (the ratings at observed cells minus the model, 0 at
unobserved ones), the factors in rank-major layout, and the pending outer
product (the deferred subtract of the last rank, reference
src/CCD.cpp:100-134). The {0,1} mask is not state: it is rebuilt from the
ratings.

``dense_state_from_numpy`` / ``dense_state_to_numpy`` convert it to and
from the JAX package's checkpoint payload (keys ``W``, ``H``, ``Rhat``,
``u_pend``, ``v_pend``; ``cuda_recommender_tpu/solvers/ccd_dense.py::
ccd_dense_train`` and ``ccd_pallas.py::ccd_pallas_train``), so both
packages can start from one state. The JAX pallas backend pads the residual
and the factors with zeros to its TPU block shape (256 x 512); the port's
state has the true (m, n) shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .hybrid_state import _to_torch, residual_from_numpy


@dataclasses.dataclass
class DenseState:
    Rhat: torch.Tensor     # (m, n) residual at observed cells, 0 elsewhere
    W: torch.Tensor        # (k, m) f32 rank-major user factors
    H: torch.Tensor        # (k, n) f32 rank-major item factors
    u_pend: torch.Tensor   # (m,) f32 — last rank's new u, not yet subtracted
    v_pend: torch.Tensor   # (n,) f32


def dense_state_from_numpy(payload: dict, shape: tuple[int, int],
                           dtype: torch.dtype, device) -> DenseState:
    """The JAX package's dense or pallas state (numpy arrays under its
    checkpoint payload keys) as a port ``DenseState`` of ``shape`` (m, n)
    on ``device``, the residual in ``dtype``. A padded (pallas) payload is
    trimmed to (m, n); raises ValueError if a trimmed residual cell or
    factor entry is not 0."""
    m, n = shape
    Rhat = np.asarray(payload["Rhat"])
    f32 = {key: np.asarray(payload[key], np.float32)
           for key in ("W", "H", "u_pend", "v_pend")}
    W, H, up, vp = f32["W"], f32["H"], f32["u_pend"], f32["v_pend"]
    if (Rhat.shape[0] < m or Rhat.shape[1] < n or W.shape[1] < m
            or H.shape[1] < n or up.shape[0] < m or vp.shape[0] < n):
        raise ValueError(f"payload (Rhat {Rhat.shape}, W {W.shape}, H "
                         f"{H.shape}) is smaller than the ({m}, {n}) matrix")
    pad = np.concatenate([Rhat[m:].astype(np.float32).ravel(),
                          Rhat[:m, n:].astype(np.float32).ravel(),
                          W[:, m:].ravel(), H[:, n:].ravel(), up[m:], vp[n:]])
    if pad.any():
        raise ValueError(f"payload cells outside the ({m}, {n}) matrix must "
                         "all be 0")
    return DenseState(
        Rhat=residual_from_numpy(Rhat[:m, :n], dtype, device),
        W=_to_torch(W[:, :m], device), H=_to_torch(H[:, :n], device),
        u_pend=_to_torch(up[:m], device), v_pend=_to_torch(vp[:n], device))


def dense_state_to_numpy(state: DenseState, *, shape=None) -> dict:
    """The port's state as a JAX-package payload of numpy arrays (a
    bfloat16 or fp8 residual comes back as its exact float32 values).
    ``shape``: the (rows, cols) to pad the residual and the factors to with
    zeros, e.g. the JAX pallas backend's block-padded shape; default: the
    state's own."""
    def host(x):
        return x.detach().to("cpu", torch.float32, copy=True).numpy()

    m, n = state.Rhat.shape
    mp, np_ = shape if shape is not None else (m, n)
    Rhat = np.zeros((mp, np_), np.float32)
    Rhat[:m, :n] = host(state.Rhat)
    return {"Rhat": Rhat,
            "W": np.pad(host(state.W), ((0, 0), (0, mp - m))),
            "H": np.pad(host(state.H), ((0, 0), (0, np_ - n))),
            "u_pend": np.pad(host(state.u_pend), (0, mp - m)),
            "v_pend": np.pad(host(state.v_pend), (0, np_ - n))}


def dense_payload_block(payload: dict, divs: tuple[int, int],
                        coord: tuple[int, int]) -> dict:
    """The block of a sharded run's global payload (padded to multiples of
    the mesh dims, as the JAX package's sharded dense run stores it) that
    the rank at mesh ``coord`` holds: its (mp/a, np/b) residual block, W's
    and u_pend's columns of its users, H's and v_pend's of its items."""
    (a, b), (i, j) = divs, coord
    mp, np_ = np.shape(payload["Rhat"])
    mb, nb = mp // a, np_ // b
    rs, cs = slice(i * mb, (i + 1) * mb), slice(j * nb, (j + 1) * nb)
    return {"Rhat": np.asarray(payload["Rhat"])[rs, cs],
            "W": np.asarray(payload["W"])[:, rs],
            "H": np.asarray(payload["H"])[:, cs],
            "u_pend": np.asarray(payload["u_pend"])[rs],
            "v_pend": np.asarray(payload["v_pend"])[cs]}


def dense_payload_assemble(parts: dict, divs: tuple[int, int]) -> dict:
    """The global payload from every rank's block payload (``parts``: key
    -> list in rank order; rank r holds block (r // b, r % b))."""
    a, b = divs
    rows = [r * b for r in range(a)]           # one rank per user block
    cols = list(range(b))                      # one rank per item block
    return {"Rhat": np.block([[parts["Rhat"][r * b + c] for c in range(b)]
                              for r in range(a)]),
            "W": np.concatenate([parts["W"][r] for r in rows], axis=1),
            "u_pend": np.concatenate([parts["u_pend"][r] for r in rows]),
            "H": np.concatenate([parts["H"][c] for c in cols], axis=1),
            "v_pend": np.concatenate([parts["v_pend"][c] for c in cols])}
