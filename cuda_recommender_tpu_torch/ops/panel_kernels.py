"""Fused CCD++ panel passes over NaN-sentinel residual panels.

Three kernels, each beside its plain PyTorch version:

  * ``panel_update_vsweep`` (K1) — ONE read-modify-write pass: applies the
    deferred-subtract + add-back delta ``outer(u_old, v_old) −
    outer(u_pend, v_pend)`` to the panel IN PLACE (the JAX package donates
    the buffer; the port writes it), rounds once to the storage dtype, and
    returns the v-sweep partials of the stored values:
    g[j] = Σ_i u_old[i]·R'[i,j]·m, h[j] = Σ_i u_old[i]²·m, m = ¬isnan(R').
  * ``panel_vsweep`` (K3) — the v-sweep partials alone (inner iterations
    i > 0), one read pass.
  * ``panel_usweep`` (K2) — the u-sweep partials, one read pass:
    g[i] = Σ_j R[i,j]·v[j]·m, h[i] = Σ_j m·v[j]².

They replace the Pallas kernels of ``cuda_recommender_tpu/ops/
panel_pallas.py`` (panel_update_vsweep, panel_vsweep, panel_usweep). A
panel is float32, bfloat16 or float8 e4m3fn. At fp8 K1 stores in one of
two orders (``order``): "once", the Pallas kernel's (the sum rounded once),
or "delta_first", the order of the JAX package's XLA panel update ``Rd +
delta.astype(dtype)`` (the delta rounded, then the sum; the hybrid without
the panel kernel); an fp8 store never saturates (ops/densify.py::
round_to_storage). The fp8 instances count under names of their own
(``instance_name``).
``panel_update_vsweep_irne`` is K1 at a bfloat16 residual with its store
rounded by integer round-to-nearest-even on the f32 bits instead of the
hardware conversion: the port of the rounding variant of ``scripts/
panel_kernel_variants.py`` (P2), a probe that must store the same bits. The
CUDA C++ source is ``csrc/panel_kernels.cu``; it says what bounds the
kernels on an H100 and how they are laid out. Panels have their true
(rows, width) shape: the kernels mask the ragged edge themselves and move
16-byte vectors on rows that start anywhere (a contiguous view may start
off a 16-byte boundary), so the TPU's block padding is gone.

Each wrapper takes the plain version ONLY for a tensor on the CPU; for a
CUDA tensor it launches the kernel (on the current stream) or raises. It
checks device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, and adds one to its count in ``ops/launches.py`` where it
launches.
"""

from __future__ import annotations

import math

import torch

from .densify import FP8, round_to_storage
from .launches import count

#: storage dtype codes of csrc/panel_kernels.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, FP8: 2}
#: store order codes of csrc/panel_kernels.cu ("delta_first": fp8 only)
_ORDER_CODE = {"once": 0, "delta_first": 1}
#: explicit mask dtype codes of csrc/panel_kernels.cu (0: no mask array,
#: the NaN sentinel)
_MASK_CODE = {torch.bfloat16: 1, torch.int8: 2}

#: rows per column-sum strip (the first pass of K1/K3's deterministic
#: two-pass reduce); a function of the shape alone, so runs repeat exactly
_ROWS_PER_PART = 512
_MAX_PARTS = 65535                   # CUDA grid.y limit
#: columns per strip: csrc/panel_kernels.cu's kStripCols (32 lanes x 8
#: consecutive columns, moved in 16-byte vectors); a strip shifts left by
#: up to _MAX_SHIFT columns onto the rows' 128-byte grid (kMaxShift; 127
#: at 1 byte a cell)
_STRIP_COLS = 256
_MAX_SHIFT = 63
#: row strips interleave in bands of this many: strip 64b + q holds the
#: rows q, q + 64, ... of band b (csrc/panel_kernels.cu's kInterleave; 128
#: at 1 byte a cell, where 64 rows of an odd width span 64 mod 128 bytes)
_INTERLEAVE = 64
#: per device and stream, the row sweep's group counters (zeros that the
#: kernel leaves zero)
_row_counts: dict = {}

#: the row sweep (K2, masked_usweep; csrc/panel_kernels.cu mirrors these as
#: kColsPerThread, kRowRuns, kRowWarps, kSpanChunks, kRowSegmentSpans,
#: kRowBlockRows): a lane's run of cells, its runs of a chunk (a warp's
#: item: 32 x ROW_RUNS runs of a row), a block's warps, the chunks a span.
#: A row of at most ROW_SEGMENT_SPANS spans is one segment; a wider row has
#: a segment a span. A block takes ROW_BLOCK_ROWS rows: of 64, 32 and 16,
#: the best or within 3.2% of it on the H100 at every panel of the Yahoo
#: stairs and the headline but r1_t's panel 1, where 64 ran 5-12% faster
#: (PERF.md §6)
ROW_RUN_CELLS = 8
ROW_RUNS = 4
ROW_WARPS = 8
ROW_SPAN_CHUNKS = 8
ROW_SEGMENT_SPANS = 3
ROW_BLOCK_ROWS = 32
ROW_CHUNK_RUNS = 32 * ROW_RUNS
ROW_SPAN_RUNS = ROW_SPAN_CHUNKS * ROW_CHUNK_RUNS

#: cells per chunk of the plain versions (bounds their f32 temporaries)
_PLAIN_CHUNK_CELLS = 1 << 26


def instance_name(kernel: str, dtype: torch.dtype,
                  order: str = "once") -> str:
    """The launch-count name of ``kernel``'s instance at a residual dtype
    and store order: the kernel's own name at f32 and bf16, else
    ``<kernel>_fp8`` and, delta-first, ``<kernel>_fp8_delta_first``."""
    if dtype != FP8:
        return kernel
    return kernel + ("_fp8_delta_first" if order == "delta_first" else "_fp8")


def _check_order(Rd: torch.Tensor, order: str) -> None:
    if order not in _ORDER_CODE:
        raise ValueError(f"store order must be 'once' or 'delta_first', got "
                         f"{order!r}")
    if order == "delta_first" and Rd.dtype != FP8:
        raise ValueError("the delta-first store order is an fp8 order; a "
                         f"{Rd.dtype} residual stores once")


def _check(Rd: torch.Tensor, rows_vecs=(), cols_vecs=()) -> tuple[int, int]:
    """Validate a panel and its factor vectors; returns (M, W)."""
    if Rd.dim() != 2:
        raise ValueError(f"panel must be 2-D, got shape {tuple(Rd.shape)}")
    if Rd.dtype not in _DTYPE_CODE:
        raise TypeError(f"panel dtype must be float32, bfloat16 or "
                        f"float8_e4m3fn, got {Rd.dtype}")
    if not Rd.is_contiguous():
        raise ValueError("panel must be contiguous (row-major)")
    if Rd.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {Rd.device}")
    M, W = Rd.shape
    for vecs, n, what in ((rows_vecs, M, "row"), (cols_vecs, W, "column")):
        for x in vecs:
            if x.dtype != torch.float32 or x.dim() != 1 or x.shape[0] != n:
                raise ValueError(f"{what} vector must be float32 of shape "
                                 f"({n},), got {x.dtype} {tuple(x.shape)}")
            if x.device != Rd.device or not x.is_contiguous():
                raise ValueError(f"{what} vector must be contiguous on "
                                 f"{Rd.device}")
    return M, W


def _interleave(cell_bytes: int) -> int:
    return 2 * _INTERLEAVE if cell_bytes == 1 else _INTERLEAVE


def _rows_per_part(M: int, cell_bytes: int = 2) -> int:
    inter = _interleave(cell_bytes)
    bands = _MAX_PARTS // inter
    need = -(-M // (bands * inter))
    return max(_ROWS_PER_PART, -(-need // 8) * 8)


def _launch(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _ptr(x: torch.Tensor):
    return x.data_ptr()


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _sweep_geometry(M: int, W: int,
                    cell_bytes: int = 2) -> tuple[int, int, int]:
    """(rows per strip, row strips, column strips) of a column sweep over
    an (M, W) panel of ``cell_bytes`` a cell: its grid is (column strips,
    row strips), the row strips _INTERLEAVE (128 at 1 byte) to a band of
    that many times rows-per-strip rows."""
    inter = _interleave(cell_bytes)
    shift = 2 * _MAX_SHIFT + 1 if cell_bytes == 1 else _MAX_SHIFT
    rpp = _rows_per_part(M, cell_bytes)
    band = inter * rpp
    return (rpp, inter * -(-M // band), -(-(W + shift) // _STRIP_COLS))


def _sweep_buffers(Rd: torch.Tensor):
    """(rows per strip, g, h, gpart, hpart): the outputs and the per-strip
    partials of a column sweep over ``Rd``, f32 on its device."""
    M, W = Rd.shape
    rpp, nparts, _ = _sweep_geometry(M, W, Rd.element_size())
    opts = dict(dtype=torch.float32, device=Rd.device)
    return (rpp, torch.empty(W, **opts), torch.empty(W, **opts),
            torch.empty((nparts, W), **opts), torch.empty((nparts, W),
                                                          **opts))


def _mask_args(M):
    """(pointer, code) of a mask for the C entry points: (None, none) for
    the NaN sentinel."""
    return (None, 0) if M is None else (_ptr(M), _MASK_CODE[M.dtype])


def _col_sweep(name: str, R, M, u_add, u_sub, v_add, v_sub,
               order: str = "once"):
    """Launch a column sweep on CUDA tensors: with the update (K1, or K4
    with a mask ``M``; stored in ``order``) or without it (``u_sub`` None:
    K3, or masked_vsweep with a mask); counted under ``name``'s instance
    (``instance_name``)."""
    from .build import load
    rows, width = R.shape
    lib = load("panel_kernels")
    rpp, g, h, gpart, hpart = _sweep_buffers(R)
    head = (_ptr(R), _DTYPE_CODE[R.dtype], *_mask_args(M))
    tail = (_ptr(gpart), _ptr(hpart), _ptr(g), _ptr(h), rows, width, rpp,
            _stream(R))
    if u_sub is None:
        _launch(lib.crtpu_vsweep, *head, _ptr(u_add), *tail)
    else:
        _launch(lib.crtpu_update_vsweep, *head, _ORDER_CODE[order],
                _ptr(u_add), _ptr(u_sub), _ptr(v_add), _ptr(v_sub), *tail)
    count(instance_name(name, R.dtype, order))
    return g, h


def row_sweep_plan(M: int, W: int, cell_bytes: int, offset: int = 0) -> dict:
    """How the row sweep (csrc/panel_kernels.cu ``row_sweep_kernel``)
    covers an (M, W) residual of ``cell_bytes`` a cell whose first cell
    lies ``offset`` bytes past a 16-byte boundary (8-byte at 1 byte a
    cell). Pure arithmetic; the wrapper launches by it, and the C side
    refuses a plan that leaves a cell or a row out.

    A row's run k holds the columns [8k - s, 8k - s + 8), s its shift:
    its first cell's place in its first unit (``unit`` bytes: 16, or 8 at
    1 byte a cell). Rows ``interleave`` = unit /
    gcd(unit, W * cell_bytes) apart share their shift; ``max_shift`` is
    the largest a row can have (the offset's where every row shares it).
    ``runs`` cover the widest row, in ``spans`` of ROW_SPAN_RUNS runs
    (ROW_SPAN_CHUNKS chunks of ROW_CHUNK_RUNS); ``chunks`` are the first
    span's (its live chunks, ``span_chunks``: a block deals a span's live
    chunks x its rows to its warps). A segment is ``segment_spans`` spans
    (``segment_cells`` columns): all of them where a row has at most
    ROW_SEGMENT_SPANS, else one; ``segments`` a row. The rows go
    ROW_BLOCK_ROWS to a group, of one class each: ``groups`` = interleave
    x ceil(ceil(M / interleave) / ROW_BLOCK_ROWS), and the grid is
    segments x groups blocks of ROW_WARPS warps (block b: segment b %
    segments of group b // segments)."""
    if M <= 0 or W <= 0:
        raise ValueError(f"empty residual {M} x {W}")
    unit = 8 if cell_bytes == 1 else 16
    inter = unit // math.gcd(unit, W * cell_bytes % unit)
    max_shift = (offset % unit // cell_bytes if inter == 1
                 else unit // cell_bytes - 1)
    runs = -(-(W + max_shift) // ROW_RUN_CELLS)
    spans = -(-runs // ROW_SPAN_RUNS)
    segment_spans = spans if spans <= ROW_SEGMENT_SPANS else 1
    segments = -(-spans // segment_spans)
    per_class = -(-M // inter)
    groups = inter * -(-per_class // ROW_BLOCK_ROWS)
    return {"unit": unit, "interleave": inter, "max_shift": max_shift,
            "runs": runs, "chunks": span_chunks(runs, 0), "spans": spans,
            "segment_spans": segment_spans,
            "segment_cells": segment_spans * ROW_SPAN_RUNS * ROW_RUN_CELLS,
            "segments": segments, "groups": groups,
            "grid": segments * groups}


def span_chunks(runs: int, span: int) -> int:
    """The live chunks of span ``span`` of a row of ``runs`` runs."""
    return min(ROW_SPAN_CHUNKS,
               -(-(runs - span * ROW_SPAN_RUNS) // ROW_CHUNK_RUNS))


def residual_plan(R: torch.Tensor) -> dict:
    """``row_sweep_plan`` of the residual R (its shape, cell size and
    offset)."""
    M, W = R.shape
    return row_sweep_plan(M, W, R.element_size(), R.data_ptr() % 16)


def _row_counters(R: torch.Tensor, groups: int) -> torch.Tensor:
    """The zeros the row groups' last-block counters start from, one
    buffer a device and stream (the kernel leaves them zero)."""
    key = (R.device.index, _stream(R))
    buf = _row_counts.get(key)
    if buf is None or buf.numel() < groups:
        buf = torch.zeros(groups, dtype=torch.int32, device=R.device)
        _row_counts[key] = buf
    return buf


def _row_sweep(name: str, R, M, v):
    """Launch a row sweep on CUDA tensors (K2, or masked_usweep with a mask
    ``M``) by ``residual_plan``; counted under ``name``'s instance."""
    from .build import load
    plan = residual_plan(R)
    rows, width = R.shape
    opts = dict(dtype=torch.float32, device=R.device)
    g, h = torch.empty(rows, **opts), torch.empty(rows, **opts)
    parts = (None, None, None)
    if plan["segments"] > 1:
        gp = torch.empty((plan["segments"], rows), **opts)
        hp = torch.empty((plan["segments"], rows), **opts)
        parts = (_ptr(gp), _ptr(hp), _ptr(_row_counters(R, plan["groups"])))
    _launch(load("panel_kernels").crtpu_usweep, _ptr(R),
            _DTYPE_CODE[R.dtype], *_mask_args(M), _ptr(v), *parts, _ptr(g),
            _ptr(h), rows, width, plan["interleave"], plan["runs"],
            plan["segments"], plan["groups"], _stream(R))
    count(instance_name(name, R.dtype))
    return g, h


def panel_update_vsweep(Rd: torch.Tensor, u_old: torch.Tensor,
                        u_pend: torch.Tensor, v_old: torch.Tensor,
                        v_pend: torch.Tensor, *, order: str = "once"):
    """K1: fused residual update (in place) + v-sweep partials for one
    NaN-sentinel panel. Rd (M, W) float32/bfloat16/float8_e4m3fn; u_* (M,)
    and v_* (W,) float32; ``order`` the store order ("delta_first": fp8
    only). Returns (g, h), each (W,) float32."""
    _check(Rd, (u_old, u_pend), (v_old, v_pend))
    _check_order(Rd, order)
    if Rd.device.type == "cpu":
        return panel_update_vsweep_plain(Rd, u_old, u_pend, v_old, v_pend,
                                         order=order)
    return _col_sweep("panel_update_vsweep", Rd, None, u_old, u_pend, v_old,
                      v_pend, order)


def panel_update_vsweep_irne(Rd: torch.Tensor, u_old: torch.Tensor,
                             u_pend: torch.Tensor, v_old: torch.Tensor,
                             v_pend: torch.Tensor):
    """K1 with the integer-RNE store (P2's rounding variant); Rd (M, W)
    bfloat16 only. Returns (g, h), each (W,) float32."""
    _check(Rd, (u_old, u_pend), (v_old, v_pend))
    if Rd.dtype != torch.bfloat16:
        raise TypeError(f"the rounding variant takes a bfloat16 panel, got "
                        f"{Rd.dtype}")
    if Rd.device.type == "cpu":
        return panel_update_vsweep_irne_plain(Rd, u_old, u_pend, v_old,
                                              v_pend)
    from .build import load
    rows, width = Rd.shape
    rpp, g, h, gpart, hpart = _sweep_buffers(Rd)
    _launch(load("panel_kernels").crtpu_update_vsweep_irne, _ptr(Rd),
            _ptr(u_old), _ptr(u_pend), _ptr(v_old), _ptr(v_pend),
            _ptr(gpart), _ptr(hpart), _ptr(g), _ptr(h), rows, width, rpp,
            _stream(Rd))
    count("panel_update_vsweep_irne")
    return g, h


def panel_vsweep(Rd: torch.Tensor, u: torch.Tensor):
    """K3: v-sweep partials only (no residual update). Returns (g, h), each
    (W,) float32."""
    _check(Rd, (u,))
    if Rd.device.type == "cpu":
        return panel_vsweep_plain(Rd, u)
    return _col_sweep("panel_vsweep", Rd, None, u, None, None, None)


def panel_usweep(Rd: torch.Tensor, v: torch.Tensor):
    """K2: u-sweep partials for one NaN-sentinel panel. Returns (g, h), each
    (M,) float32."""
    _check(Rd, (), (v,))
    if Rd.device.type == "cpu":
        return panel_usweep_plain(Rd, v)
    return _row_sweep("panel_usweep", Rd, None, v)


# ---- plain PyTorch versions (the CPU path and the kernels' oracle) ----

def _row_chunks(M: int, W: int):
    rows = max(1, _PLAIN_CHUNK_CELLS // max(1, W))
    return ((r0, min(M, r0 + rows)) for r0 in range(0, M, rows))


def _masked_f32(blk: torch.Tensor):
    """(f32 values with NaN cells zeroed, f32 {0,1} mask) of a panel block."""
    x = blk.to(torch.float32)
    m = ~torch.isnan(x)
    return torch.where(m, x, 0.0), m.to(torch.float32)


def round_irne(x: torch.Tensor) -> torch.Tensor:
    """f32 -> bfloat16 by integer round-to-nearest-even on the bits,
    (bits + 0x7FFF + lsb) >> 16; NaN by the dtype conversion (the kernel's
    RoundIntRne)."""
    b = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = ((b + 0x7FFF + ((b >> 16) & 1)) >> 16) & 0xFFFF
    r = torch.where(r >= 0x8000, r - 0x10000, r).to(torch.int16)
    return torch.where(torch.isnan(x), x.to(torch.bfloat16),
                       r.view(torch.bfloat16))


def store(blk: torch.Tensor, s: torch.Tensor, rounding=None) -> None:
    """blk[...] = the f32 ``s`` rounded once to blk's dtype (by
    ``rounding``, f32 -> that dtype, when given); an fp8 block through
    ``round_to_storage``, never the saturating cast."""
    if rounding is not None:
        s = rounding(s)
    elif blk.dtype == FP8:
        s = round_to_storage(s, FP8)
    blk.copy_(s)


def rounded_f32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The f32 value of ``x`` (f32) rounded to ``dtype``."""
    return x if dtype == torch.float32 else round_to_storage(
        x, dtype).to(torch.float32)


def panel_update_vsweep_plain(Rd, u_old, u_pend, v_old, v_pend, *,
                              rounding=None, order="once"):
    """Plain version of K1: the same delta fl(fl(uo·vo) − fl(up·vp)) added
    to the residual in f32. "once": the sum rounded ONCE to the storage
    dtype by the in-place store (or by ``rounding``, f32 -> storage dtype);
    "delta_first": the delta rounded to the storage dtype first, then the
    sum. The sums read the stored values back."""
    M, W = Rd.shape
    g = torch.zeros(W, dtype=torch.float32, device=Rd.device)
    h = torch.zeros_like(g)
    for r0, r1 in _row_chunks(M, W):
        blk = Rd[r0:r1]
        d = torch.outer(u_old[r0:r1], v_old)
        d.sub_(torch.outer(u_pend[r0:r1], v_pend))
        if order == "delta_first":
            d = rounded_f32(d, blk.dtype)
        d.add_(blk.to(torch.float32))
        store(blk, d, rounding)
        del d
        x, m = _masked_f32(blk)
        u = u_old[r0:r1]
        g += torch.mv(x.t(), u)
        h += torch.mv(m.t(), u * u)
    return g, h


def panel_update_vsweep_irne_plain(Rd, u_old, u_pend, v_old, v_pend):
    """Plain version of the rounding variant: K1's plain version with the
    store rounded by ``round_irne``."""
    return panel_update_vsweep_plain(Rd, u_old, u_pend, v_old, v_pend,
                                     rounding=round_irne)


def panel_vsweep_plain(Rd, u):
    """Plain version of K3."""
    M, W = Rd.shape
    g = torch.zeros(W, dtype=torch.float32, device=Rd.device)
    h = torch.zeros_like(g)
    for r0, r1 in _row_chunks(M, W):
        x, m = _masked_f32(Rd[r0:r1])
        uu = u[r0:r1]
        g += torch.mv(x.t(), uu)
        h += torch.mv(m.t(), uu * uu)
    return g, h


def panel_usweep_plain(Rd, v):
    """Plain version of K2."""
    M, W = Rd.shape
    g = torch.empty(M, dtype=torch.float32, device=Rd.device)
    h = torch.empty_like(g)
    vv = v * v
    for r0, r1 in _row_chunks(M, W):
        x, m = _masked_f32(Rd[r0:r1])
        g[r0:r1] = torch.mv(x, v)
        h[r0:r1] = torch.mv(m, vv)
    return g, h
