"""Stream and gather probes: the card's measurement controls.

Three kernels (``csrc/probe_kernels.cu``), each beside its plain PyTorch
version:

  * ``stream_rmw`` — ``R <- bf16(R + 1)`` IN PLACE over an (M, W) bfloat16
    panel: the read-modify-write control, its cells walked flat in 16-byte
    vectors (the function is per cell, so the Pallas control's two grid
    orders compute it alike). Replaces ``rmw_call`` of
    ``scripts/panel_floor.py`` (P1) and the rmw floor of
    ``scripts/panel_kernel_variants.py`` (P2).
  * ``stream_read`` — the read control: with ``u``, g[j] = Σ_b u[512·b] ·
    Σ_{i in block b} R[i, j] over 512-row blocks (the weight is u at each
    block's FIRST row, as the Pallas body reads ``u_ref[0, 0]``; the last
    block is ragged), replacing ``read_call`` of ``scripts/panel_floor.py``
    (P1); without ``u``, g[j] = Σ_i R[i, j] with NaN read as 0, the read
    floor of ``scripts/panel_kernel_variants.py`` (P2). 16-byte loads, a
    256-column tile and a range of whole 512-row blocks a block, the grid
    sized to the card (``read_plan``), the ranges' sums added by each
    tile's last block in a fixed order (``read_sum_order``;
    ``stream_read_in_order`` repeats that order on any device).
  * ``gather`` — forms A, B, C of ``scripts/probe_vmem_gather.py`` (P3)
    over an f32 table ``tab`` (S, L) and an int32 index tile ``idx``
    (rows, L): A ``out[r, l] = tab[idx[r, l], l]``, B ``out[r, l] =
    tab.flatten()[idx[r, l]]``, C ``out[r, :] = tab[idx[r, 0], :]``. An
    index outside the table reads 0. A and B take one of two kernels by
    the table's bytes (``gather_plan``): the table copied into each SM's
    shared memory where it fits in a block's opt-in shared memory (counted
    as ``gather_smem``), else read from L2 under an evict-last policy
    (counted as ``gather``, as form C is).

Each wrapper takes the plain version ONLY for a tensor on the CPU; for a
CUDA tensor it launches the kernel (on the current stream) or raises. It
checks device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, and adds one to its count in ``ops/launches.py`` where it
launches.
"""

from __future__ import annotations

import ctypes

import torch

from .launches import count
from .panel_kernels import _launch, _ptr, _row_chunks, _stream

#: rows per block of ``stream_read``'s weighting (the Pallas probes' BM)
BLOCK_ROWS = 512
#: gather forms -> the C entry point's mode code
GATHER_MODES = {"A": 0, "B": 1, "C": 2}
#: gather paths of forms A and B -> the C entry point's path code
GATHER_PATHS = {"l2": 0, "smem": 1}
#: elements a thread takes a step, and threads a block, of each kernel of
#: forms A and B: the L2 path's, and the shared-memory path's with the
#: whole table or (form A, aligned, L a multiple of 32) a column group
GATHER_STEP = {"l2": 4, "table": 8, "cols": 8}
GATHER_THREADS = {"l2": 128, "table": 256, "cols": 512}
#: the L2 path's blocks an SM (the kernel's launch bounds)
GATHER_L2_BLOCKS_PER_SM = 8
#: blocks of the whole-table kernel that share one read of the table
GATHER_TABLE_CLUSTER = 4
#: lanes of a column group
GATHER_COL_LANES = 32
#: shared memory the shared-memory path needs besides the table: the
#: mbarrier and a zero (16 bytes), and 16 for a table off a 16-byte boundary
GATHER_SMEM_RESERVE = 32
#: the H100's opt-in shared memory a block and its SMs: what a CPU tensor's
#: plan assumes (``gather_limits``)
H100_SMEM_OPTIN = 232_448
H100_SMS = 132

#: stream_read's kernel (csrc/probe_kernels.cu mirrors these as kRead*):
#: warps a block, and a tile's columns on each row path (a warp's row: 32
#: lanes of 8 cells; on the shifted path lane 31 owns none)
READ_WARPS = 8
READ_TILE_COLS = {"aligned": 256, "shifted": 248}
#: the H100's resident stream_read blocks an SM (the card reports each
#: instance's, ``read_blocks_per_sm``): what a CPU tensor's plan assumes
H100_READ_BLOCKS_PER_SM = 4
#: row paths -> the C entry point's ``aligned`` flag
READ_PATHS = {"shifted": 0, "aligned": 1}
#: 512-row blocks a thread block of the shifted path reads (about: the
#: ranges' sizes differ by at most one). Neighbouring tiles there share
#: cache lines at every tile boundary; short blocks dispatched tile by
#: tile keep neighbours on the same rows, so that the L2 serves what they
#: share (on the H100 one wave of long blocks ran 7% slower at the bench's
#: panel 0, PERF.md)
READ_SHIFT_ROW_BLOCKS = 4

_limits: dict = {}
_read_blocks: dict = {}
_read_counts: dict = {}


def _check_panel(R: torch.Tensor) -> tuple[int, int]:
    if R.dim() != 2 or R.dtype != torch.bfloat16:
        raise TypeError(f"panel must be 2-D bfloat16, got {R.dtype} "
                        f"{tuple(R.shape)}")
    if not R.is_contiguous():
        raise ValueError("panel must be contiguous (row-major)")
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {R.device}")
    return R.shape


def read_plan(M: int, W: int, offset: int = 0, sms: int = H100_SMS,
              per_sm: int = H100_READ_BLOCKS_PER_SM) -> dict:
    """How ``crtpu_stream_read`` reads an (M, W) bfloat16 panel whose
    first cell lies ``offset`` bytes past a 16-byte boundary (even, 0-14)
    on a card with ``sms`` SMs, each holding ``per_sm`` of the kernel's
    blocks at once. Pure arithmetic, which the C side takes as given and
    checks.

    ``path``: "aligned" where offset is 0 and W a multiple of 8 (every row
    starts on a 16-byte boundary), else "shifted"; ``warp_offsets``: the
    bytes past a 16-byte boundary at which each of the 8 warps' rows start
    (warp y reads the rows y, y + 8, ...; 8 rows are 16 W bytes). The
    columns are ``tiles`` tiles of ``tile_cols`` (READ_TILE_COLS[path];
    the last ragged); each tile's ``blocks`` = ceil(M / 512) row blocks go
    to ``ranges`` ranges of whole row blocks whose sizes differ by at most
    one (range k: row blocks [k blocks // ranges, (k + 1) blocks //
    ranges)), a thread block each: ``grid`` = tiles x ranges, thread block
    b taking tile b mod tiles and range b // tiles (``read_block``). On the
    aligned path ``ranges`` is the most that keep the grid within one wave
    of per_sm x sms blocks (at least 1, at most ``blocks``): of the grids
    of one wave, the fullest, and its largest range the fewest row blocks.
    On the shifted path a range is about READ_SHIFT_ROW_BLOCKS row blocks
    (ceil(blocks / READ_SHIFT_ROW_BLOCKS) ranges), several waves."""
    if offset % 2 or not 0 <= offset < 16:
        raise ValueError(f"a bfloat16 panel starts at an even offset mod 16, "
                         f"got {offset}")
    if M <= 0 or W <= 0:
        raise ValueError(f"empty panel {M} x {W}")
    path = read_path(offset, W)
    cols = READ_TILE_COLS[path]
    tiles, blocks = -(-W // cols), -(-M // BLOCK_ROWS)
    ranges = (max(1, min(blocks, per_sm * sms // tiles)) if path == "aligned"
              else -(-blocks // READ_SHIFT_ROW_BLOCKS))
    return {"path": path, "warp_offsets": tuple((offset + 2 * y * W) % 16
                                                for y in range(READ_WARPS)),
            "tile_cols": cols, "tiles": tiles, "blocks": blocks,
            "ranges": ranges, "grid": tiles * ranges}


def read_path(offset: int, W: int) -> str:
    """The row path of a panel of width W whose first cell lies ``offset``
    bytes past a 16-byte boundary: "aligned" where every row starts on
    one (offset 0, W a multiple of 8), else "shifted"."""
    return "aligned" if offset == 0 and W % 8 == 0 else "shifted"


def read_block(plan: dict, b: int) -> tuple[int, int, int]:
    """(tile, first row block, row block past the last) of thread block
    ``b`` of ``plan``'s grid."""
    k, nb, ranges = b // plan["tiles"], plan["blocks"], plan["ranges"]
    return b % plan["tiles"], k * nb // ranges, (k + 1) * nb // ranges


def read_sum_order(ranges: int) -> tuple:
    """The order in which a tile's last block adds the ranges' column sums:
    warp w the ranges w, w + 8, ... in order, then the warps' sums in warp
    order (the outer tuple)."""
    return tuple(tuple(range(w, ranges, READ_WARPS))
                 for w in range(READ_WARPS))


def read_blocks_per_sm(device: torch.device, nan_skip: bool,
                       path: str) -> int:
    """The stream_read instance's resident blocks an SM on ``device`` (a
    CUDA device's occupancy, read once an instance and device; the H100's
    for the CPU)."""
    if device.type != "cuda":
        return H100_READ_BLOCKS_PER_SM
    key = (_index(device), nan_skip, path)
    if key not in _read_blocks:
        from .build import load
        n = ctypes.c_int()
        _launch(load("probe_kernels").crtpu_stream_read_blocks,
                int(nan_skip), READ_PATHS[path], ctypes.byref(n))
        _read_blocks[key] = n.value
    return _read_blocks[key]


def stream_read_plan(R: torch.Tensor, nan_skip: bool) -> dict:
    """``read_plan`` for the panel R on its device (its offset, SMs and the
    instance's occupancy)."""
    M, W = R.shape
    offset = R.data_ptr() % 16
    per_sm = read_blocks_per_sm(R.device, nan_skip, read_path(offset, W))
    return read_plan(M, W, offset, gather_limits(R.device)[1], per_sm)


def _read_counters(R: torch.Tensor, tiles: int) -> torch.Tensor:
    """The zeros the tiles' last-block counters start from, one buffer a
    device and stream (the kernel leaves them zero)."""
    key = (_index(R.device), _stream(R))
    buf = _read_counts.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(tiles, dtype=torch.int32, device=R.device)
        _read_counts[key] = buf
    return buf


def stream_rmw(R: torch.Tensor) -> torch.Tensor:
    """P1/P2 rmw: R += 1 in bfloat16, in place; returns R."""
    M, W = _check_panel(R)
    if R.device.type == "cpu":
        return stream_rmw_plain(R)
    from .build import load
    _launch(load("probe_kernels").crtpu_stream_rmw, _ptr(R), M, W,
            _stream(R))
    count("stream_rmw")
    return R


def stream_read(R: torch.Tensor, u: torch.Tensor | None = None
                ) -> torch.Tensor:
    """P1 read (with ``u``, (M,) float32) or P2's NaN-skip read floor
    (without), by ``stream_read_plan``. Returns g, (W,) float32."""
    M, W = _check_panel(R)
    if u is not None and (u.dtype != torch.float32 or u.shape != (M,)
                          or u.device != R.device or not u.is_contiguous()):
        raise ValueError(f"u must be contiguous float32 of shape ({M},) on "
                         f"{R.device}")
    if R.device.type == "cpu":
        return stream_read_plain(R, u)
    return launch_read(R, u, stream_read_plan(R, u is None))


def launch_read(R: torch.Tensor, u: torch.Tensor | None, plan: dict
                ) -> torch.Tensor:
    """One launch of stream_read's kernel on the CUDA panel R (checked by
    ``stream_read``) as ``plan`` says: its path and ranges
    (``scripts/sweep_timing.py --read-levers`` times other plans than
    ``stream_read_plan``'s; the C side refuses the aligned path where R
    does not allow it)."""
    from .build import load
    M, W = R.shape
    opts = dict(dtype=torch.float32, device=R.device)
    g = torch.empty(W, **opts)
    gpart = torch.empty((plan["ranges"], W), **opts)
    _launch(load("probe_kernels").crtpu_stream_read, _ptr(R),
            None if u is None else _ptr(u), _ptr(gpart),
            _ptr(_read_counters(R, plan["tiles"])), _ptr(g), M, W,
            READ_PATHS[plan["path"]], plan["ranges"], _stream(R))
    count("stream_read")
    return g


def gather_smem_bytes(S: int, L: int) -> int:
    """Dynamic shared memory of the shared-memory path for an (S, L) f32
    table: the table rounded up to 16 bytes, plus GATHER_SMEM_RESERVE."""
    return GATHER_SMEM_RESERVE + -(-4 * S * L // 16) * 16


def gather_plan(S: int, L: int, n_idx: int, smem_limit: int, *,
                form: str = "B", sms: int = H100_SMS, path: str | None = None,
                tab_offset: int = 0, idx_offset: int = 0,
                out_offset: int = 0) -> dict:
    """How ``crtpu_gather`` runs form ``form`` ("A" or "B") over an (S, L)
    f32 table and ``n_idx`` index elements, on a device with
    ``smem_limit`` bytes of opt-in shared memory a block and ``sms`` SMs;
    the offsets are the table's, the index's and the output's addresses
    mod 16 (bytes). ``path`` None picks "smem" where
    ``gather_smem_bytes(S, L)`` fits in ``smem_limit``, else "l2"; asking
    for "smem" where it does not fit raises ValueError. Returns {"path",
    "kernel" ("l2"; on the shared-memory path "cols" for form A with every
    offset 0 and L a multiple of 32, else "table"), "grid" (blocks; the
    table kernel's clusters of GATHER_TABLE_CLUSTER are also capped by how
    many the card runs at once, which only the card knows),
    "threads", "per_thread" (elements a thread takes a step), "smem_bytes",
    "head" and "tail" (elements before the output's first 16-byte step and
    after its last, one a thread), "steps", "idx_vec" (the index is read
    16 bytes at a time)}. Pure arithmetic, mirrored by the C entry point."""
    need = gather_smem_bytes(S, L)
    if path is None:
        path = "smem" if need <= smem_limit else "l2"
    if path not in GATHER_PATHS:
        raise ValueError(f"path must be one of {sorted(GATHER_PATHS)}, got "
                         f"{path!r}")
    if path == "smem" and need > smem_limit:
        raise ValueError(f"a {S} x {L} f32 table needs {need} bytes of "
                         f"shared memory; a block may opt in to "
                         f"{smem_limit}")
    kernel = "l2"
    if path == "smem":
        aligned = not (tab_offset % 16 or idx_offset % 16 or out_offset % 16)
        kernel = ("cols" if form == "A" and aligned
                  and L % GATHER_COL_LANES == 0 else "table")
    step, threads = GATHER_STEP[kernel], GATHER_THREADS[kernel]
    if kernel == "cols":
        groups, rows = L // GATHER_COL_LANES, n_idx // L
        want = -(-rows * (GATHER_COL_LANES // step) // threads)
        return {"path": path, "kernel": kernel,
                "grid": groups * max(1, min(want, sms // groups)),
                "threads": threads, "per_thread": step,
                "smem_bytes": 16 + S * GATHER_COL_LANES * 4, "head": 0,
                "tail": 0, "steps": n_idx // step, "idx_vec": True}
    head = min(n_idx, (16 - out_offset % 16) % 16 // 4)
    steps = (n_idx - head) // step
    if kernel == "table":   # whole clusters, at most a block an SM
        c = GATHER_TABLE_CLUSTER
        grid = c * max(1, min(-(-steps // (threads * c)), sms // c))
    else:
        grid = max(1, min(-(-steps // threads),
                          sms * GATHER_L2_BLOCKS_PER_SM))
    return {"path": path, "kernel": kernel, "grid": grid,
            "threads": threads, "per_thread": step,
            "smem_bytes": need if path == "smem" else 0, "head": head,
            "tail": n_idx - head - steps * step, "steps": steps,
            "idx_vec": (idx_offset + 4 * head) % 16 == 0}


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def gather_limits(device: torch.device) -> tuple[int, int]:
    """(opt-in shared memory a block, SMs) that ``gather_plan`` and
    ``read_plan`` take for ``device``: a CUDA device's, read once a
    device through the kernel library; the H100's for the CPU (whose plain
    version has no limit of its own)."""
    if device.type != "cuda":
        return H100_SMEM_OPTIN, H100_SMS
    index = _index(device)
    if index not in _limits:
        from .build import load
        smem, sms = ctypes.c_int(), ctypes.c_int()
        _launch(load("probe_kernels").crtpu_gather_limits, index,
                ctypes.byref(smem), ctypes.byref(sms))
        _limits[index] = (smem.value, sms.value)
    return _limits[index]


def gather(tab: torch.Tensor, idx: torch.Tensor, form: str, *,
           out: torch.Tensor | None = None,
           path: str | None = None) -> torch.Tensor:
    """P3 form ``form`` ("A", "B" or "C") of ``tab`` (S, L) float32 at
    ``idx`` (rows, L) int32, into ``out`` (contiguous (rows, L) float32 on
    the same device; allocated when None). ``path`` ("smem" or "l2", forms
    A and B only) overrides ``gather_plan``'s choice; "smem" for a table
    over the device's limit (the H100's for a CPU tensor) raises. Returns
    out."""
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
    if out is not None and (out.shape != idx.shape or
                            out.dtype != torch.float32 or
                            not out.is_contiguous() or
                            out.device != idx.device):
        raise ValueError(f"out must be contiguous float32 of shape "
                         f"{tuple(idx.shape)} on {idx.device}")
    if form == "C" and path is not None:
        raise ValueError("form C has one kernel; path is for forms A and B")
    S, L = tab.shape
    plan = None
    if form != "C":
        smem_limit, sms = gather_limits(tab.device)
        plan = gather_plan(S, L, idx.numel(), smem_limit, form=form, sms=sms,
                           path=path)
    if tab.device.type == "cpu":
        got = gather_plain(tab, idx, form)
        return got if out is None else out.copy_(got)
    from .build import load
    if out is None:
        out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    code = 0 if plan is None else GATHER_PATHS[plan["path"]]
    _launch(load("probe_kernels").crtpu_gather, _ptr(tab), _ptr(idx),
            _ptr(out), idx.shape[0], L, S, GATHER_MODES[form], code,
            _stream(idx))
    count("gather_smem" if code else "gather")
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


def stream_read_in_order(R: torch.Tensor, u: torch.Tensor | None,
                         plan: dict) -> torch.Tensor:
    """stream_read's kernel's additions, in its order, on R's device, by
    ``plan``'s ranges: within a range a thread of warp y adds the rows y, y
    + 8, ... of each 512-row block in order (NaN-skip: into one sum, NaN
    read as +0.0; weighted: a sum a block, then the range's sum + it times
    u at the block's first row), a range's column sum is its 8 warps' in
    warp order, and g adds the ranges in ``read_sum_order``. Every
    addition a float32 one, rounded to nearest, none fused with a product:
    the kernel's bits (the smoke holds them equal on the card; this loops
    over rows in Python, for small panels)."""
    M, W = R.shape
    nb, ranges = plan["blocks"], plan["ranges"]
    opts = dict(dtype=torch.float32, device=R.device)
    parts = []
    for k in range(ranges):
        acc = torch.zeros((READ_WARPS, W), **opts)
        for b in range(k * nb // ranges, (k + 1) * nb // ranges):
            x = torch.zeros((BLOCK_ROWS, W), **opts)
            x[:min(M, (b + 1) * BLOCK_ROWS) - b * BLOCK_ROWS] = \
                R[b * BLOCK_ROWS:(b + 1) * BLOCK_ROWS]
            x = x.view(-1, READ_WARPS, W)        # [i, y]: row 8 i + y
            if u is None:
                x = torch.where(torch.isnan(x), 0.0, x)
            s = acc if u is None else torch.zeros_like(acc)
            for i in range(x.shape[0]):
                s = s + x[i]
            acc = s if u is None else acc + s * u[b * BLOCK_ROWS]
        part = torch.zeros(W, **opts)
        for y in range(READ_WARPS):
            part = part + acc[y]
        parts.append(part)
    g = torch.zeros(W, **opts)
    for warp in read_sum_order(ranges):
        q = torch.zeros(W, **opts)
        for k in warp:
            q = q + parts[k]
        g = g + q
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
