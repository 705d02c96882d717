"""The ALS gram assembly in one hand-written kernel (``als_gram``).

``als_gram(idx, val, counts, other, E, p)`` returns the augmented grams
Gaug (S, k+1, k+1) float32 of the S = rows·p slots of one ELL bucket row
group: Gaug[s] = Σ_e f_e f_eᵀ over the slot's lanes, f_e = [other[idx[s,
e]] | val[s, e]], so that G = Gaug[:, :k, :k] and r = Gaug[:, :k, k] are
the slot's normal equations (solvers/als_ell.py, K5). idx (rows, p·E)
int64 and val (rows, p·E) float32 hold slot s's lanes in [s·E, (s+1)·E)
(data/ell.py); counts (S,) float32 is each slot's number of ratings, which
sit in its first lanes (every later lane is the zero slot with value 0);
other (n, k) float32 is the other side's factor table, 1 <= k <= 128.

On a CUDA tensor it launches ``csrc/als_kernels.cu``: the factor rows go
straight from ``other`` into shared memory, the kernel reads each slot's
real lanes only and accumulates the f32 gram there, with no gathered
operand in device memory (the source says what bounds it and how). A
bucket wider than ``SEGMENT_LANES`` cuts each slot into segments by lane
position (``segment_plan``); their partial grams go to scratch and a second
short kernel adds them in segment order, so the result repeats bit for bit.
It replaces no TPU kernel: XLA fused this gather into its einsum on the
TPU.

``als_gram_plain`` is its plain PyTorch version, the port's gather and f32
``torch.bmm`` as they were before the kernel: Faug = [F | val] gathered
from the augmented table (``augmented_table``) over every lane of the
layout, then one batched product. It reads all lanes, the padded ones
included: on a layout from data/ell.py those gather the zero row with value
0 and add exact zeros, so both compute one function.

The wrapper checks device, dtypes, shapes, contiguity and k on every
device, takes the plain version ONLY for tensors on the CPU, and for CUDA
tensors launches the kernel or raises; it allocates the output (and the
scratch) with ``torch.empty`` and adds one to ``als_gram`` in
``ops/launches.py`` for each kernel launched (two where slots split).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .launches import count

#: largest k the kernel serves (K5's range)
MAX_K = 128
#: lanes of one segment: a slot of a bucket wider than this is cut into
#: ceil(E / SEGMENT_LANES) segments, each a thread block's work
SEGMENT_LANES = 1024
#: counts are float32, exact below 2^24: the widest bucket served
MAX_E = 1 << 24


def augmented_table(other: torch.Tensor, width: Optional[int] = None
                    ) -> torch.Tensor:
    """The other side's factors (n, k) as the gather table of the augmented
    assembly: (n + 1, width) f32, width k + 1 by default; zero row n (the
    ELL pad lanes' zero slot, ``extend_zero``), column k where each lane's
    rating goes, and zero columns after it."""
    n, k = other.shape
    table = other.new_zeros((n + 1, width or k + 1))
    table[:n, :k] = other
    return table


def segments(E: int) -> int:
    """Segments a slot of a bucket of width E is cut into (1: whole)."""
    return -(-E // SEGMENT_LANES)


def launches_per_call(E: int) -> int:
    """Kernel launches of one ``als_gram`` call at bucket width E."""
    return 1 + (segments(E) > 1)


def segment_plan(counts: np.ndarray, E: int) -> tuple:
    """The kernel's work items over one row group, as NumPy arrays: for item
    i (thread block i), its slot, its first lane within the slot and its
    number of lanes, the slot's real lanes from ``first`` on, at most
    ``SEGMENT_LANES`` of them. Item i is segment i % m of slot i // m,
    m = ``segments(E)``; with m > 1 it writes partial gram i."""
    m = segments(E)
    item = np.arange(counts.size * m, dtype=np.int64)
    slot, first = item // m, item % m * SEGMENT_LANES
    real = np.clip(np.asarray(counts).astype(np.int64), 0, E)
    lanes = np.clip(real[slot] - first, 0, SEGMENT_LANES)
    return slot, first, lanes


def _check(idx, val, counts, other, E: int, p: int) -> tuple[int, int]:
    """Validate one row group's operands; returns (S, k)."""
    if idx.dtype != torch.int64:
        raise TypeError(f"idx must be int64, got {idx.dtype}")
    for name, x in (("val", val), ("counts", counts), ("other", other)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if idx.dim() != 2 or val.shape != idx.shape or other.dim() != 2 \
            or counts.dim() != 1:
        raise ValueError(f"need idx and val (rows, L), counts (S,) and other "
                         f"(n, k), got {tuple(idx.shape)}, "
                         f"{tuple(val.shape)}, {tuple(counts.shape)} and "
                         f"{tuple(other.shape)}")
    if not 1 <= E <= MAX_E or p < 1 or idx.shape[1] != E * p:
        raise ValueError(f"need 1 <= E <= 2^24 and L = p·E, got E={E}, "
                         f"p={p}, L={idx.shape[1]}")
    S, k = idx.shape[0] * p, other.shape[1]
    if counts.shape[0] != S:
        raise ValueError(f"need {S} counts (rows·p), got {counts.shape[0]}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} is outside the kernel's range "
                         f"1 <= k <= {MAX_K}")
    if other.shape[0] >= 2 ** 31:
        raise ValueError(f"other has {other.shape[0]} rows, the kernel's "
                         "indices are 32-bit")
    if not all(x.is_contiguous() for x in (idx, val, counts, other)):
        raise ValueError("idx, val, counts and other must be contiguous")
    devices = {x.device for x in (idx, val, counts, other)}
    if len(devices) != 1 or other.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the operands must be on one cpu or cuda device, "
                         f"got {devices}")
    return S, k


def als_gram(idx: torch.Tensor, val: torch.Tensor, counts: torch.Tensor,
             other: torch.Tensor, E: int, p: int) -> torch.Tensor:
    """Gaug (S, k+1, k+1) float32 of one bucket row group (module
    docstring)."""
    S, k = _check(idx, val, counts, other, E, p)
    if other.device.type == "cpu":
        return als_gram_plain(idx, val, counts, other, E, p)
    out = torch.empty((S, k + 1, k + 1), dtype=torch.float32,
                      device=other.device)
    if S == 0:
        return out
    m = segments(E)
    part = (torch.empty((S * m, k + 1, k + 1), dtype=torch.float32,
                        device=other.device) if m > 1 else None)
    from .build import load
    err = load("als_kernels").crtpu_als_gram(
        idx.data_ptr(), val.data_ptr(), counts.data_ptr(), other.data_ptr(),
        other.shape[0], out.data_ptr(),
        None if part is None else part.data_ptr(), S, E, SEGMENT_LANES, k,
        torch.cuda.current_stream(other.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"crtpu_als_gram failed: CUDA error {err}")
    for _ in range(launches_per_call(E)):
        count("als_gram")
    return out


def als_gram_plain(idx: torch.Tensor, val: torch.Tensor,
                   counts: torch.Tensor, other: torch.Tensor, E: int,
                   p: int) -> torch.Tensor:
    """Plain version of ``als_gram``: the gather of Faug = [F | val] from
    the augmented table over every lane (``counts`` is not read: the
    padded lanes add exact zeros), then one f32 ``torch.bmm`` Faugᵀ Faug."""
    k = other.shape[1]
    S = idx.shape[0] * p
    f = augmented_table(other)[idx.reshape(S, E)]          # (S, E, k+1)
    f[:, :, k] = val.reshape(S, E)
    return torch.bmm(f.transpose(1, 2), f)
