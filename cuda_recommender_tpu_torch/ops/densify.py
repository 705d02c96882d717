"""COO -> dense residual block (the port of
``cuda_recommender_tpu/ops/densify.py::densify_coo``), in its two modes:

  * NaN mode (``densify_coo_nan``): unobserved cells hold NaN, so no mask
    array exists; observed cells hold the rating rounded once to the
    residual dtype.
  * explicit-mask mode (``densify_coo_mask``): a zero residual holding the
    ratings, and a {0,1} mask of ``bfloat16`` or ``int8`` (both exact).

A residual is float32, bfloat16 or float8 e4m3fn. Every store into an fp8
tensor in the port goes through ``round_to_storage``: PyTorch's own cast
saturates at ±448, while JAX's ``astype`` (the JAX package's every fp8
store) rounds to nearest even and turns |x| > 464 and ±inf into NaN; a
saturated store would leave a cell observed that the JAX package has made
unobserved. Torch has few fp8 operators, so fp8 tensors are filled and
scattered through their uint8 bits.

One ``index_put_`` scatter per array: the JAX package chunks its scatter to
bound a TPU index-layout temporary, which a GPU does not have. This replaces
the reference's host-side CSR assembly role (reference src/tools.cpp:3-85)
for the dense and panel layouts; the reference never densifies.
"""

from __future__ import annotations

import numpy as np
import torch

FP8 = torch.float8_e4m3fn
#: Config.residual_dtype -> torch dtype of the residual
RESIDUAL_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float8_e4m3fn": FP8}
#: Config.mask_dtype -> torch dtype of an explicit mask
MASK_DTYPES = {"bfloat16": torch.bfloat16, "int8": torch.int8}
#: |x| above this rounds past fp8 e4m3fn's largest finite value (448): the
#: midpoint to the next step, 480, which the format spends on NaN
FP8_OVERFLOW = 464.0
#: the fp8 NaN bits (sign clear)
FP8_NAN_BITS = 0x7F


def round_to_storage(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (float32) rounded to the residual dtype ``dtype``. float32 and
    bfloat16: PyTorch's conversion (round to nearest even). fp8 e4m3fn: bit
    for bit JAX's ``astype``: round to nearest even without saturating, so
    |x| > 464 and ±inf store NaN, with x's sign, as NaN does. PyTorch's
    cast rounds the same way up to 464 and saturates beyond (or, on some
    builds, gives NaN), so only the cells beyond are fixed up."""
    if dtype != FP8:
        return x.to(dtype)
    x = x.to(torch.float32)
    bits = x.to(FP8).view(torch.uint8)
    over = x.abs() > FP8_OVERFLOW            # NaN compares False
    return torch.where(over, bits | FP8_NAN_BITS, bits).view(FP8)


def store_order(dtype: torch.dtype, rounds_once: bool) -> str:
    """The store order of a residual update: "once" (the sum rounded once
    to ``dtype``: the Pallas kernels' order, ``rounds_once``) or, at fp8
    where the JAX path computes ``R + (delta·mask).astype(dtype)`` in XLA,
    "delta_first" (the delta rounded, then the sum). float32 and bfloat16
    residuals store once on every path."""
    return "delta_first" if dtype == FP8 and not rounds_once else "once"


def _filled(shape, value: float, dtype, device) -> torch.Tensor:
    """A ``dtype`` tensor of ``value`` (fp8 through its uint8 bits)."""
    if dtype != FP8:
        return torch.full(shape, value, dtype=dtype, device=device)
    bits = int(round_to_storage(torch.tensor([value]), FP8)
               .view(torch.uint8))
    return torch.full(shape, bits, dtype=torch.uint8,
                      device=device).view(FP8)


def _scatter(Rd: torch.Tensor, li, ci, vals) -> None:
    """Rd[li, ci] = vals (f32) rounded to Rd's dtype, in place."""
    if Rd.dtype == FP8:
        Rd.view(torch.uint8).index_put_(
            (li, ci), round_to_storage(vals, FP8).view(torch.uint8))
    else:
        Rd.index_put_((li, ci), vals.to(Rd.dtype))


def _coo(lr, lc, lv, device):
    return (torch.as_tensor(np.asarray(lr, np.int64), device=device),
            torch.as_tensor(np.asarray(lc, np.int64), device=device),
            torch.as_tensor(np.asarray(lv, np.float32), device=device))


def densify_coo_nan(lr: np.ndarray, lc: np.ndarray, lv: np.ndarray,
                    rows: int, width: int, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """(rows, width) ``dtype`` panel on ``device``: NaN everywhere except
    the COO cells (lr, lc), which get ``lv``. COO pairs must be unique."""
    Rd = _filled((rows, width), float("nan"), dtype, device)
    if len(lr):
        _scatter(Rd, *_coo(lr, lc, lv, device))
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
    Rd = _filled((rows, width), 0.0, dtype, device)
    Md = torch.zeros((rows, width), dtype=mdt, device=device)
    if len(lr):
        li, ci, vals = _coo(lr, lc, lv, device)
        _scatter(Rd, li, ci, vals)
        Md.index_put_((li, ci), torch.ones((), dtype=mdt, device=device))
    return Rd, Md
