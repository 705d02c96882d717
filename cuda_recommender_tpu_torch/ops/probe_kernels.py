"""Stream and gather probes: the card's measurement controls.

Three kernels (``csrc/probe_kernels.cu``), each beside its plain PyTorch
version, the two streams in two load patterns each: the 2-byte tile
pattern (K1's former layout: 512 x 128 tiles and 2-byte loads; the
access-pattern diagnostic) or, with ``vec16=True``, 16-byte
vectors (the achievable control; counted apart, as ``stream_rmw_vec16``
and ``stream_read_vec16``):

  * ``stream_rmw`` — ``R <- bf16(R + 1)`` IN PLACE over an (M, W) bfloat16
    panel: the read-modify-write control, in the 2-byte tiles walked in
    column-of-tiles (``row_major=False``) or row-of-tiles order, or in
    16-byte vectors over the cells as one flat run. Replaces ``rmw_call``
    of ``scripts/panel_floor.py`` (P1) and the rmw floor of
    ``scripts/panel_kernel_variants.py`` (P2).
  * ``stream_read`` — the read control: with ``u``, g[j] = Σ_b u[512·b] ·
    Σ_{i in block b} R[i, j] over 512-row blocks (the weight is u at each
    block's FIRST row, as the Pallas body reads ``u_ref[0, 0]``; the last
    block is ragged), replacing ``read_call`` of ``scripts/panel_floor.py``
    (P1); without ``u``, g[j] = Σ_i R[i, j] with NaN read as 0, the read
    floor of ``scripts/panel_kernel_variants.py`` (P2).
  * ``gather`` — forms A, B, C of ``scripts/probe_vmem_gather.py`` (P3)
    over an f32 table ``tab`` (S, L) and an int32 index tile ``idx``
    (rows, L): A ``out[r, l] = tab[idx[r, l], l]``, B ``out[r, l] =
    tab.flatten()[idx[r, l]]``, C ``out[r, :] = tab[idx[r, 0], :]``. An
    index outside the table reads 0.

Each wrapper takes the plain version ONLY for a tensor on the CPU; for a
CUDA tensor it launches the kernel (on the current stream) or raises. It
checks device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, and adds one to its count in ``ops/launches.py`` where it
launches.
"""

from __future__ import annotations

import torch

from .launches import count
from .panel_kernels import _launch, _ptr, _row_chunks, _stream

#: rows per block of ``stream_read``'s weighting (the Pallas probes' BM)
BLOCK_ROWS = 512
#: gather forms -> the C entry point's mode code
GATHER_MODES = {"A": 0, "B": 1, "C": 2}


def _check_panel(R: torch.Tensor) -> tuple[int, int]:
    if R.dim() != 2 or R.dtype != torch.bfloat16:
        raise TypeError(f"panel must be 2-D bfloat16, got {R.dtype} "
                        f"{tuple(R.shape)}")
    if not R.is_contiguous():
        raise ValueError("panel must be contiguous (row-major)")
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {R.device}")
    return R.shape


def stream_rmw(R: torch.Tensor, *, row_major: bool = False,
               vec16: bool = False) -> torch.Tensor:
    """P1/P2 rmw: R += 1 in bfloat16, in place; returns R."""
    M, W = _check_panel(R)
    if vec16 and row_major:
        raise ValueError("the 16-byte pattern walks the cells flat; it has "
                         "no tile order")
    if R.device.type == "cpu":
        return stream_rmw_plain(R)
    from .build import load
    _launch(load("probe_kernels").crtpu_stream_rmw, _ptr(R), M, W,
            2 if vec16 else int(row_major), _stream(R))
    count("stream_rmw_vec16" if vec16 else "stream_rmw")
    return R


def stream_read(R: torch.Tensor, u: torch.Tensor | None = None, *,
                vec16: bool = False) -> torch.Tensor:
    """P1 read (with ``u``, (M,) float32) or P2's NaN-skip read floor
    (without). Returns g, (W,) float32."""
    M, W = _check_panel(R)
    if u is not None and (u.dtype != torch.float32 or u.shape != (M,)
                          or u.device != R.device or not u.is_contiguous()):
        raise ValueError(f"u must be contiguous float32 of shape ({M},) on "
                         f"{R.device}")
    if R.device.type == "cpu":
        return stream_read_plain(R, u)
    from .build import load
    nparts = -(-M // BLOCK_ROWS)
    opts = dict(dtype=torch.float32, device=R.device)
    g, gpart = torch.empty(W, **opts), torch.empty((nparts, W), **opts)
    _launch(load("probe_kernels").crtpu_stream_read, _ptr(R),
            None if u is None else _ptr(u), _ptr(gpart), _ptr(g), M, W,
            int(vec16), _stream(R))
    count("stream_read_vec16" if vec16 else "stream_read")
    return g


def gather(tab: torch.Tensor, idx: torch.Tensor, form: str) -> torch.Tensor:
    """P3 form ``form`` ("A", "B" or "C") of ``tab`` (S, L) float32 at
    ``idx`` (rows, L) int32. Returns out, (rows, L) float32."""
    if form not in GATHER_MODES:
        raise ValueError(f"form must be one of {sorted(GATHER_MODES)}, got "
                         f"{form!r}")
    if tab.dim() != 2 or tab.dtype != torch.float32:
        raise TypeError(f"table must be 2-D float32, got {tab.dtype} "
                        f"{tuple(tab.shape)}")
    if idx.dim() != 2 or idx.dtype != torch.int32 or \
            idx.shape[1] != tab.shape[1]:
        raise TypeError(f"index must be 2-D int32 with {tab.shape[1]} "
                        f"columns, got {idx.dtype} {tuple(idx.shape)}")
    if not (tab.is_contiguous() and idx.is_contiguous()) or \
            tab.device != idx.device:
        raise ValueError("table and index must be contiguous, on one device")
    if tab.device.type == "cpu":
        return gather_plain(tab, idx, form)
    from .build import load
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    _launch(load("probe_kernels").crtpu_gather, _ptr(tab), _ptr(idx),
            _ptr(out), idx.shape[0], idx.shape[1], tab.shape[0],
            GATHER_MODES[form], _stream(idx))
    count("gather")
    return out


# ---- plain PyTorch versions (the CPU path and the kernels' oracle) ----

def stream_rmw_plain(R: torch.Tensor) -> torch.Tensor:
    """Plain version of stream_rmw: the f32 sum rounded once to bf16."""
    M, W = R.shape
    for r0, r1 in _row_chunks(M, W):
        blk = R[r0:r1]
        blk.copy_(blk.to(torch.float32).add_(1.0))
    return R


def stream_read_plain(R: torch.Tensor, u: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain version of stream_read: each 512-row block's f32 column sum,
    times u at the block's first row (or NaN read as 0 and no weight),
    added in block order."""
    M, W = R.shape
    g = torch.zeros(W, dtype=torch.float32, device=R.device)
    for r0 in range(0, M, BLOCK_ROWS):
        x = R[r0:r0 + BLOCK_ROWS].to(torch.float32)
        if u is None:
            g += torch.where(torch.isnan(x), 0.0, x).sum(0)
        else:
            g += x.sum(0) * u[r0]
    return g


def gather_plain(tab: torch.Tensor, idx: torch.Tensor, form: str
                 ) -> torch.Tensor:
    """Plain version of gather (an index outside the table reads 0)."""
    S, L = tab.shape
    ix = idx.to(torch.int64)
    if form == "C":
        ix = ix[:, :1].expand(-1, L)
    n = S * L if form == "B" else S
    ok = (ix >= 0) & (ix < n)
    ixc = torch.where(ok, ix, 0)
    if form == "A":                       # row idx, column = the lane
        ixc = ixc * L + torch.arange(L, device=idx.device)
    got = tab[ixc[:, 0]] if form == "C" else tab.reshape(-1)[ixc]
    return torch.where(ok, got, 0.0)
