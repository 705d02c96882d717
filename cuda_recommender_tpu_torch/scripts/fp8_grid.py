"""The fp8 store's boundary grid: a panel on which the fp8 update's
roundings land on every boundary there is.

Its cells hold every one of the 256 float8 e4m3fn bytes as R, against
deltas (``deltas``) that hold every fp8 value (so that a delta-first
store's second rounding, of R + round(delta), meets every pair of fp8
values: every tie a sum of two can make), every midpoint between
neighbouring fp8 values and one f32 ULP either side of it (the ties to
even in each binade and among the subnormals), the overflow edge (448,
463, 464, 465, 480 and beyond), ±0, ±inf and NaN, each with both signs,
padded with seeded values over fp8's range to a multiple of 128 columns.

Cell (r, c) holds byte (r + c) mod 256: each column meets every byte
within 256 rows, and neighbours in a row hold neighbouring bytes, so NaN
(0x7F, 0xFF) lies beside a finite cell in one pair. Column c takes the
delta D[c mod |D|]: u_old = 1, u_pend = v_pend = 0 and v_old[c] = D[c mod
|D|] give fl(1·v) − fl(0·0) = v, exactly, however a path contracts it. The
rows come in GRID_BLOCKS blocks of 256; with an explicit mask, block b of
column c is unobserved (0) where (b + c) mod 3 == 0, so every byte meets
every delta both under a 0 (delta·mask = −0 for a negative delta, NaN for
±inf and NaN) and under a 1. Any width works (columns past |D| repeat the
deltas); odd widths shift every row's start.
"""

from __future__ import annotations

import numpy as np
import torch

#: blocks of 256 rows
GRID_BLOCKS = 3
#: the seed of the padding values
_SEED = 0


def fp8_values() -> np.ndarray:
    """The 256 fp8 e4m3fn values, by byte, as float32 (NaN at 0x7F,
    0xFF)."""
    return torch.arange(256, dtype=torch.uint8).view(
        torch.float8_e4m3fn).to(torch.float32).numpy()


def deltas() -> np.ndarray:
    """The grid's deltas (module docstring), float32, a multiple of 128."""
    vals = fp8_values()
    fin = np.unique(vals[np.isfinite(vals)])
    mids = ((fin[:-1].astype(np.float64) + fin[1:]) / 2).astype(np.float32)
    ulps = (np.nextafter(mids, np.float32(np.inf)),
            np.nextafter(mids, np.float32(-np.inf)))
    edge = np.array([448, 460, 463, 463.99997, 464, 464.00003, 465, 470, 479,
                     480, 481, 500, 1e6, 3e38, np.inf, 0.0, 2 ** -9,
                     2 ** -10, 3 * 2 ** -11, 2 ** -6, 2 ** -7], np.float32)
    nans = np.array([0x7FC00000, 0x7F800001], np.uint32).view(np.float32)
    d = np.concatenate([vals, mids, *ulps, edge, nans])
    d = np.concatenate([d, -d])
    _, first = np.unique(d.view(np.uint32), return_index=True)
    d = d[np.sort(first)]
    pad = -len(d) % 128
    rng = np.random.default_rng(_SEED)
    fill = (rng.uniform(-1, 1, pad) * np.exp2(rng.integers(-10, 9, pad)))
    return np.concatenate([d, fill.astype(np.float32)])


def grid_np(W: int, mask: bool = False) -> tuple:
    """(R's bytes (rows, W) uint8, the {0,1} mask as float32 or None,
    [u_old, u_pend, v_old, v_pend] float32) of the grid at width ``W``."""
    rows = 256 * GRID_BLOCKS
    r = np.arange(rows)[:, None]
    c = np.arange(W)[None, :]
    R = ((r + c) % 256).astype(np.uint8)
    d = deltas()
    vecs = [np.ones(rows, np.float32), np.zeros(rows, np.float32),
            d[np.arange(W) % len(d)], np.zeros(W, np.float32)]
    M = None
    if mask:
        M = ((r // 256 + c) % 3 != 0).astype(np.float32)
    return R, M, vecs


def grid(W: int, device, mask_dtype=None) -> tuple:
    """``grid_np`` on ``device``: (R float8_e4m3fn, the mask in
    ``mask_dtype`` or None for the NaN sentinel, the four vectors)."""
    R, M, vecs = grid_np(W, mask_dtype is not None)
    Rt = torch.from_numpy(R).to(device).view(torch.float8_e4m3fn)
    Mt = None if M is None else torch.from_numpy(M).to(device).to(mask_dtype)
    return Rt, Mt, [torch.from_numpy(v).to(device) for v in vecs]
