"""Training state of the hybrid backend, and its exchange with the JAX
package.

``HybridState`` is what one outer step reads and updates in place: the
panel residuals, both ELL residual value sets, the factors in degree-sorted
order, and the pending outer product (the deferred subtract of the last
rank, reference src/CCD.cpp:100-134). With explicit panel masks it also
holds the masks, which are read-only and rebuilt from the plan.

``hybrid_state_from_numpy`` / ``hybrid_state_to_numpy`` convert it to and
from the JAX package's checkpoint payload (keys ``W``, ``H``, ``u_pend``,
``v_pend``, ``Rd_i``, ``vals_r_i``, ``vals_c_i``;
``cuda_recommender_tpu/solvers/ccd_hybrid.py::ccd_hybrid_train``), so a
checkpoint of either package resumes in the other. The JAX package's
panel-kernel path stores each panel padded with NaN to its TPU block shape
(``padded_panel_shape``, copied here) and reads its payload back with no
reshape, so the port writes that shape for such a run; the port's panels
have their true ``(r1 - r0, w)`` shape, and the reader trims. The JAX
payload has no masks (``ccd_hybrid.py:1026-1047`` rebuilds them from the
plan), so neither does the port's.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..ops.densify import FP8, densify_coo_mask, round_to_storage


#: the JAX panel kernels' block shape (rows x cols), read from the same
#: environment variables as its ops/panel_pallas.py BM, BW
BM = int(os.environ.get("CRTPU_PANEL_BM", "512"))
BW = int(os.environ.get("CRTPU_PANEL_BW", "2048"))


def padded_panel_shape(M: int, W: int) -> tuple[int, int]:
    """The JAX panel-kernel path's allocation shape of an (M, W) panel
    (its ops/panel_pallas.py::padded_panel_shape, one device): each dim
    rounded up to a multiple of its block, the block clamped to the dim."""
    bm_, bw_ = min(BM, M), min(BW, W)
    return (-(-M // bm_) * bm_, -(-W // bw_) * bw_)


@dataclasses.dataclass
class HybridState:
    Rds: list          # per panel (r1-r0, w) residual; unobserved cells
    #                    hold NaN, or 0 beside an explicit mask
    vals_r: list       # rows-side ELL residual value tiles (rows, L) f32
    vals_c: list       # cols-side ELL residual value tiles
    W: torch.Tensor    # (k, m) f32, degree-sorted user order
    H: torch.Tensor    # (k, n) f32, degree-sorted item order
    u_pend: torch.Tensor   # (m,) f32 — last rank's new u, not yet subtracted
    v_pend: torch.Tensor   # (n,) f32
    #: per panel (r1-r0, w) {0,1} bfloat16/int8 mask; empty = NaN sentinel
    masks: list = dataclasses.field(default_factory=list)


def _to_torch(x: np.ndarray, device) -> torch.Tensor:
    """numpy -> a torch copy on ``device``, bit-exact; bfloat16 and fp8
    payloads (the JAX package's ml_dtypes arrays) travel as their bit
    patterns."""
    x = np.ascontiguousarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).to(device, copy=True).view(
            torch.bfloat16)
    if x.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(x.view(np.uint8)).to(device, copy=True).view(
            FP8)
    return torch.from_numpy(x).to(device, copy=True)


def residual_from_numpy(x: np.ndarray, dtype, device) -> torch.Tensor:
    """A payload's residual block on ``device`` in ``dtype`` (None: as it
    is). A checkpoint stores a bf16 or fp8 residual widened to f32, so the
    value comes back exactly. An fp8 residual is rounded on the host, in
    row blocks (``round_to_storage``, as JAX's astype rounds), and ships as
    its bytes."""
    if dtype != FP8 or x.dtype.name == "float8_e4m3fn":
        t = _to_torch(x, device)
        return t if dtype is None else t.to(dtype)
    src = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    out = torch.empty(src.shape, dtype=torch.uint8)
    rows = max(1, (1 << 24) // max(1, src.shape[1]))
    for r0 in range(0, src.shape[0], rows):
        out[r0:r0 + rows] = round_to_storage(src[r0:r0 + rows], FP8).view(
            torch.uint8)
    return out.to(device).view(FP8)


def hybrid_state_from_numpy(payload: dict, plan, device,
                            mask_dtype: str = "nan",
                            dtype=None) -> HybridState:
    """The JAX package's hybrid state (numpy arrays under its checkpoint
    payload keys) as a port ``HybridState`` on ``device``. Panels are
    trimmed to their true (r1 - r0, w) shape and cast to ``dtype`` when
    given (a checkpoint stores a bf16 or fp8 panel widened to f32: exact
    both ways; ``residual_from_numpy``); raises ValueError if a trimmed
    cell is not NaN, or not 0 with
    an explicit mask (i.e. was an observed rating). With ``mask_dtype``
    "bfloat16" or "int8" the masks are rebuilt from the plan's panel COO
    (``materialize_dense=False``)."""
    nan = mask_dtype == "nan"
    Rds, masks = [], []
    for i, (r0, r1, w) in enumerate(plan.panels):
        x = np.asarray(payload[f"Rd_{i}"])
        M = r1 - r0
        if x.shape[0] < M or x.shape[1] < w:
            raise ValueError(f"Rd_{i} shape {x.shape} is smaller than panel "
                             f"{(M, w)}")
        pad = np.concatenate([x[M:].astype(np.float32).ravel(),
                              x[:M, w:].astype(np.float32).ravel()])
        if not (np.isnan(pad).all() if nan else not pad.any()):
            raise ValueError(f"Rd_{i}: cells outside the ({M}, {w}) panel "
                             f"must all be {'NaN' if nan else '0'}")
        Rds.append(residual_from_numpy(x[:M, :w], dtype, device))
        if not nan:
            lr, lc, lv = plan.panel_coo[i]
            masks.append(densify_coo_mask(lr, lc, lv, M, w, torch.float32,
                                          mask_dtype, device)[1])
    nr = len(plan.ell.rows_side.buckets)
    nc = len(plan.ell.cols_side.buckets)
    f32 = np.float32
    return HybridState(
        Rds=Rds,
        vals_r=[_to_torch(np.asarray(payload[f"vals_r_{i}"], f32), device)
                for i in range(nr)],
        vals_c=[_to_torch(np.asarray(payload[f"vals_c_{i}"], f32), device)
                for i in range(nc)],
        W=_to_torch(np.asarray(payload["W"], f32), device),
        H=_to_torch(np.asarray(payload["H"], f32), device),
        u_pend=_to_torch(np.asarray(payload["u_pend"], f32), device),
        v_pend=_to_torch(np.asarray(payload["v_pend"], f32), device),
        masks=masks)


def hybrid_state_to_numpy(state: HybridState, *, panel_shapes=None) -> dict:
    """The port's state as a JAX-package payload of numpy arrays (bfloat16
    and fp8 panels come back as their exact float32 values).
    ``panel_shapes``: per panel the (rows, cols) to pad to with NaN (0 with
    explicit masks), e.g. ``padded_panel_shape`` for the JAX panel-kernel
    path; default: the panels' own shapes."""
    def host(x):
        return x.detach().to("cpu", torch.float32, copy=True).numpy()

    payload = {"W": host(state.W), "H": host(state.H),
               "u_pend": host(state.u_pend), "v_pend": host(state.v_pend)}
    for i, Rd in enumerate(state.Rds):
        if panel_shapes is None:
            payload[f"Rd_{i}"] = host(Rd)
            continue
        # copy into the padded array's corner: one f32 host array a panel
        full = np.full(panel_shapes[i], 0.0 if state.masks else np.nan,
                       np.float32)
        torch.from_numpy(full)[:Rd.shape[0], :Rd.shape[1]].copy_(Rd)
        payload[f"Rd_{i}"] = full
    for i, v in enumerate(state.vals_r):
        payload[f"vals_r_{i}"] = host(v)
    for i, v in enumerate(state.vals_c):
        payload[f"vals_c_{i}"] = host(v)
    return payload


#: payload keys a sharded hybrid run holds whole on every rank
REPLICATED = ("W", "H", "u_pend", "v_pend")


def hybrid_payload_block(payload: dict, plan, shard: int,
                         num_shards: int) -> dict:
    """The block of a sharded run's global payload (the JAX package's
    layout: each panel's rows the concatenation of N equal per-shard
    blocks, each block-padded on its own in a panel-kernel payload; each
    bucket tile shard-major) that rank ``shard`` holds. ``plan`` is the
    global N-aligned plan; the factors and pending vectors are whole."""
    out = {key: payload[key] for key in REPLICATED}
    for i in range(len(plan.panels)):
        x = np.asarray(payload[f"Rd_{i}"])
        per = x.shape[0] // num_shards
        out[f"Rd_{i}"] = x[shard * per:(shard + 1) * per]
    for key, side in (("vals_r", plan.ell.rows_side),
                      ("vals_c", plan.ell.cols_side)):
        for i, b in enumerate(side.buckets):
            r = b.rows_per_shard
            out[f"{key}_{i}"] = np.asarray(
                payload[f"{key}_{i}"])[shard * r:(shard + 1) * r]
    return out
