"""COO -> dense residual block (the port of
``cuda_recommender_tpu/ops/densify.py::densify_coo``), in its two modes:

  * NaN mode (``densify_coo_nan``): unobserved cells hold NaN, so no mask
    array exists; observed cells hold the rating rounded once to the
    residual dtype.
  * explicit-mask mode (``densify_coo_mask``): a zero residual holding the
    ratings, and a {0,1} mask of ``bfloat16`` or ``int8`` (both exact).

One ``index_put_`` scatter per array: the JAX package chunks its scatter to
bound a TPU index-layout temporary, which a GPU does not have. This replaces
the reference's host-side CSR assembly role (reference src/tools.cpp:3-85)
for the dense and panel layouts; the reference never densifies.
"""

from __future__ import annotations

import numpy as np
import torch

#: Config.residual_dtype -> torch dtype of the residual (the port runs no
#: fp8 residual)
RESIDUAL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: Config.mask_dtype -> torch dtype of an explicit mask
MASK_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}


def _coo(lr, lc, lv, device):
    return (torch.as_tensor(np.asarray(lr, np.int64), device=device),
            torch.as_tensor(np.asarray(lc, np.int64), device=device),
            torch.as_tensor(np.asarray(lv, np.float32), device=device))


def densify_coo_nan(lr: np.ndarray, lc: np.ndarray, lv: np.ndarray,
                    rows: int, width: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """(rows, width) ``dtype`` panel on ``device``: NaN everywhere except
    the COO cells (lr, lc), which get ``lv``. COO pairs must be unique."""
    Rd = torch.full((rows, width), float("nan"), dtype=dtype, device=device)
    if len(lr):
        li, ci, vals = _coo(lr, lc, lv, device)
        Rd.index_put_((li, ci), vals.to(dtype))
    return Rd


def densify_coo_mask(lr: np.ndarray, lc: np.ndarray, lv: np.ndarray,
                     rows: int, width: int, dtype: torch.dtype,
                     mask_dtype: str, device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(residual, mask), each (rows, width) on ``device``: the residual is
    ``dtype`` zeros with ``lv`` at the COO cells, the mask ``mask_dtype``
    ("bfloat16" or "int8") zeros with 1 there. COO pairs must be unique."""
    if mask_dtype not in MASK_DTYPES:
        raise ValueError(f"explicit mask dtype must be one of "
                         f"{sorted(MASK_DTYPES)}, got {mask_dtype!r}")
    mdt = MASK_DTYPES[mask_dtype]
    Rd = torch.zeros((rows, width), dtype=dtype, device=device)
    Md = torch.zeros((rows, width), dtype=mdt, device=device)
    if len(lr):
        li, ci, vals = _coo(lr, lc, lv, device)
        Rd.index_put_((li, ci), vals.to(dtype))
        Md.index_put_((li, ci), torch.ones((), dtype=mdt, device=device))
    return Rd, Md
