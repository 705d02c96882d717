"""The card's published peaks, and the least times of the work the cells do.

Peaks: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's data sheet, dense
rates: 3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores,
989 TFLOP/s in bfloat16 on them. Every share is against these; the card's
power limit is reported beside each run (``card``).
"""

from __future__ import annotations

import subprocess

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12

#: bytes of one stored residual cell, by the configuration's dtype
RESIDUAL_BYTES = {"float32": 4, "bfloat16": 2, "float8_e4m3fn": 1}
#: bytes of one rating's index in the problem's own terms (an int32 id)
INDEX_BYTES = 4


def card(device) -> dict:
    """The contract's ``device`` record of one card: platform, name, count
    and, as ``power_limit``, ``nvidia-smi``'s name and power limit."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out["power_limit"] = "not read"
    return out


def ccd_step_bytes(nnz: int, k: int, residual_dtype: str) -> float:
    """Least bytes of one CCD++ outer iteration (one inner iteration), in
    the problem's terms: for every rank, each rating's residual is read
    and written once by the update and read once more by the second
    half-sweep, and its two int32 ids are read once. Counted from nnz, k
    and the residual's dtype alone, never from the layout's cells."""
    return k * nnz * (3 * RESIDUAL_BYTES[residual_dtype] + 2 * INDEX_BYTES)


def als_step_flops(nnz: int, rows: int, cols: int, k: int) -> float:
    """Least float32 operations of one ALS outer iteration: on each side,
    every rating adds its (k+1)^2 augmented outer product (gram and right
    side; a multiply and an add each), and every entity solves its k x k
    system (2k^3/3 for the factorisation, 2k^2 for the two triangular
    solves)."""
    grams = 2 * nnz * 2 * (k + 1) ** 2
    solves = (rows + cols) * (2 * k ** 3 / 3 + 2 * k ** 2)
    return grams + solves


def assembly_bound(nnz: int, slots: int, k: int, precision: str) -> tuple:
    """(ms, what bounds it): the least time of one ALS outer iteration's
    gram and rhs assembly (the gathers and the products) at
    ``precision``. Its inputs are each rating's lane index (int64) and
    value (f32) on both sides, read once; its output the (k+1)^2 augmented
    gram of every slot, f32, written once; its work 2 (k+1)^2 operations a
    rating and side, in f32 outside the tensor cores ("highest") or bf16
    on them (one pass; three for "high")."""
    nbytes = 2 * nnz * 12 + slots * (k + 1) ** 2 * 4
    flops = 2 * nnz * 2 * (k + 1) ** 2
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = (flops / PEAK_F32_FLOP_S if precision == "highest" else
             flops * (3 if precision == "high" else 1) / PEAK_BF16_FLOP_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def panel_bytes(panels, k: int, residual_dtype: str) -> float:
    """Bytes the panel kernels must move in one outer iteration: for every
    rank, K1 reads and writes each panel cell and K2 reads it."""
    cells = sum((r1 - r0) * w for r0, r1, w in panels)
    return k * cells * 3 * RESIDUAL_BYTES[residual_dtype]
