"""Batched pivot-free Gauss-Jordan solve of small SPD systems (K5).

``gj_solve(A, b)`` returns x = A⁻¹b for a batch of S float32 k×k systems,
A (S, k, k) and b (S, k), 1 <= k <= 128: the ALS normal equations
F_Ω^T F_Ω + λI, SPD with their mass on the diagonal. It replaces the Pallas
kernel ``cuda_recommender_tpu/ops/gj_pallas.py::gj_solve_pallas_bl``; the
CUDA C++ source is ``csrc/gj_kernels.cu``, which says what bounds the
kernel on an H100 and how it is laid out. It is bound by instruction issue,
not memory, so it spends issue only on needed work: step i updates only
the live columns i+1 .. k (finished columns are never read again for x),
and up to k = 64 the rows lie across the lanes of one warp with the
columns in registers, the steps unrolled at compile time, so a row's
multiplier is a register and no shuffle, select or block barrier is left
in a step; the width is k padded to a multiple of 8 as identity. Above
k = 64 a block holds a system, columns across lanes, and skips the column
slots that are wholly finished. Both keep x bit-equal to the plain
version (tests/test_torch_gj.py holds the live-column order and the
identity padding bit-equal on the CPU; chip_smoke.py the kernel on the
card). The JAX kernel's batch-last (k, k+1, 128-lane) layout and its
identity padding of S were the TPU's; here the batch is the leading axis,
as the assembly makes it, and a ragged S needs no padding.

``gj_solve_plain(A, b)`` is its plain PyTorch version, the port of the JAX
package's ``gauss_jordan_solve`` (solvers/als_ell.py): the same pivot-free
elimination, one k-step at a time over the whole batch.

The wrapper takes the plain version ONLY for a tensor on the CPU; for a
CUDA tensor it launches the kernel (on the current stream) or raises. It
checks device, dtype, shape and strides, allocates x with ``torch.empty``,
and adds one to its count in ``ops/launches.py`` where it launches. A and b
may be strided views (A's columns contiguous), e.g. of an augmented
(S, k+1, k+1) gram; the kernel reads them in place.
"""

from __future__ import annotations

import torch

from .launches import count

#: largest k the kernel serves (the JAX kernel's range,
#: tests/test_pallas.py:68-87)
MAX_K = 128


def _check(A: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """Validate a batch of systems; returns (S, k)."""
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"A and b must be float32, got {A.dtype}, {b.dtype}")
    if A.dim() != 3 or b.dim() != 2 or A.shape[1] != A.shape[2] \
            or tuple(b.shape) != tuple(A.shape[:2]):
        raise ValueError(f"need A (S, k, k) and b (S, k), got "
                         f"{tuple(A.shape)} and {tuple(b.shape)}")
    S, k = b.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k} is outside the kernel's range "
                         f"1 <= k <= {MAX_K}")
    if A.device != b.device or A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"A and b must be on one cpu or cuda device, got "
                         f"{A.device} and {b.device}")
    if A.stride(2) != 1 and k > 1:
        raise ValueError("A's columns must be contiguous (stride 1)")
    return S, k


def gj_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5: x (S, k) float32 with A[s] x[s] = b[s]."""
    S, k = _check(A, b)
    if A.device.type == "cpu":
        return gj_solve_plain(A, b)
    x = torch.empty((S, k), dtype=torch.float32, device=A.device)
    if S == 0:
        return x
    from .build import load
    err = load("gj_kernels").crtpu_gj_solve(
        A.data_ptr(), A.stride(0), A.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), x.data_ptr(), S, k,
        torch.cuda.current_stream(A.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"crtpu_gj_solve failed: CUDA error {err}")
    count("gj_solve")
    return x


def gj_solve_plain(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: pivot-free Gauss-Jordan on the augmented
    (S, k, k+1) system, k full-batch steps of prow = row / d,
    M -= col * prow, row i = prow. ~k·S·k·(k+1) multiply-adds, like a
    direct solve; the product ``col * prow`` is rounded before the
    subtract, as in the kernel."""
    S, k = b.shape
    M = torch.cat([A, b.unsqueeze(-1)], dim=2)           # (S, k, k+1)
    for i in range(k):
        prow = M[:, i, :] / M[:, i, i:i + 1]             # (S, k+1)
        M -= M[:, :, i:i + 1] * prow.unsqueeze(1)
        M[:, i, :] = prow
    return M[:, :, k].contiguous()
