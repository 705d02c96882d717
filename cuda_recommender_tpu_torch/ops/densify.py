"""COO -> dense NaN-sentinel residual panel (the port of the NaN mode of
``cuda_recommender_tpu/ops/densify.py::densify_coo``).

Unobserved cells hold NaN, so no mask array exists; observed cells hold the
rating rounded once to the residual dtype. One ``index_put_`` scatter: the
JAX package chunks its scatter to bound a TPU index-layout temporary, which
a GPU does not have. This replaces the reference's host-side CSR assembly
role (reference src/tools.cpp:3-85) for the panel layout; the reference
never densifies.
"""

from __future__ import annotations

import numpy as np
import torch


def densify_coo_nan(lr: np.ndarray, lc: np.ndarray, lv: np.ndarray,
                    rows: int, width: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """(rows, width) ``dtype`` panel on ``device``: NaN everywhere except
    the COO cells (lr, lc), which get ``lv``. COO pairs must be unique."""
    Rd = torch.full((rows, width), float("nan"), dtype=dtype, device=device)
    if len(lr):
        li = torch.as_tensor(np.asarray(lr, np.int64), device=device)
        ci = torch.as_tensor(np.asarray(lc, np.int64), device=device)
        vals = torch.as_tensor(np.asarray(lv, np.float32), device=device)
        Rd.index_put_((li, ci), vals.to(dtype))
    return Rd
