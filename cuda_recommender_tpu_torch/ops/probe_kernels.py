"""Stream and gather probes: the card's measurement controls.

Three kernels (``csrc/probe_kernels.cu``), each beside its plain PyTorch
version, the two streams in two designs each: a ring of shared-memory
stages filled by bulk asynchronous copies (TMA), the streams' own kernels,
whose geometry ``stream_plan`` computes; or, with ``vec16=True``, 16-byte
vectors loaded a batch a thread (the design the ring is timed against;
counted apart, as ``stream_rmw_vec16`` and ``stream_read_vec16``):

  * ``stream_rmw`` — ``R <- bf16(R + 1)`` IN PLACE over an (M, W) bfloat16
    panel: the read-modify-write control, its cells walked flat (the
    function is per cell, so the Pallas control's two grid orders compute
    it alike). Replaces ``rmw_call`` of ``scripts/panel_floor.py`` (P1)
    and the rmw floor of ``scripts/panel_kernel_variants.py`` (P2).
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
#: shared memory the card keeps for itself a block: an SM holds the opt-in
#: plus this (233,472 bytes on the H100), shared by its blocks
SMEM_BLOCK_RESERVE = 1024

#: the streams' ring (csrc/probe_kernels.cu mirrors these as kRing*): the
#: consumer threads a block, and the block with its producer warp; the
#: read's columns a consumer, so that a column strip is at most
#: STREAM_STRIP columns; bytes before the stages (two mbarriers a stage);
#: the most row segments a stage of several strips (a producer lane
#: copies one)
STREAM_THREADS = 256
STREAM_BLOCK = STREAM_THREADS + 32
STREAM_COLS_PER_THREAD = 8
STREAM_STRIP = STREAM_THREADS * STREAM_COLS_PER_THREAD
STREAM_SMEM_HEAD = 128
STREAM_MAX_SEGMENT_ROWS = 32
#: the plan's choices: the rmw's bytes a stage (a chunk), the read's bytes a
#: stage (whole row segments up to it), blocks an SM, and the stages a block
#: wants (as many as fit its share of the SM's shared memory, between these;
#: the kernels refuse fewer than the first and take at most 8)
STREAM_CHUNK = 32 << 10
STREAM_STAGE_BYTES = 32 << 10
STREAM_CTAS_PER_SM = 2
STREAM_STAGES = (3, 6)
#: a read block's fewest rows (per_cta) where a strip has several ranges:
#: a (512-row block, strip) piece is then split between at most two blocks
STREAM_MIN_RANGE_ROWS = BLOCK_ROWS

_limits: dict = {}


def _check_panel(R: torch.Tensor) -> tuple[int, int]:
    if R.dim() != 2 or R.dtype != torch.bfloat16:
        raise TypeError(f"panel must be 2-D bfloat16, got {R.dtype} "
                        f"{tuple(R.shape)}")
    if not R.is_contiguous():
        raise ValueError("panel must be contiguous (row-major)")
    if R.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {R.device}")
    return R.shape


def _stages(stage_bytes: int, smem_optin: int) -> tuple[int, int]:
    """(blocks an SM, stages a block) of a ring of ``stage_bytes`` stages:
    STREAM_CTAS_PER_SM blocks, each with as many stages as fit its share
    of the SM's shared memory (at most the upper bound of STREAM_STAGES).
    Raises ValueError where that share holds fewer than the lower bound
    (the H100's holds 3 of the largest stage, 32 KB)."""
    lo, hi = STREAM_STAGES
    cps = STREAM_CTAS_PER_SM
    share = (smem_optin + SMEM_BLOCK_RESERVE) // cps - SMEM_BLOCK_RESERVE
    stages = min(hi, (share - STREAM_SMEM_HEAD) // stage_bytes)
    if stages < lo:
        raise ValueError(f"{cps} blocks an SM of {lo} stages of {stage_bytes}"
                         f" bytes do not fit {smem_optin} bytes of opt-in "
                         f"shared memory a block")
    return cps, stages


def stream_plan(M: int, W: int, offset: int = 0,
                smem_optin: int = H100_SMEM_OPTIN, sms: int = H100_SMS, *,
                op: str = "rmw") -> dict:
    """How the ring kernels (``crtpu_stream_rmw``, ``crtpu_stream_read``
    at mode 0) stream an (M, W) bfloat16 panel whose first cell lies
    ``offset`` bytes past a 16-byte boundary (even, 0-14), on a device with
    ``smem_optin`` bytes of opt-in shared memory a block and ``sms`` SMs.
    Pure arithmetic, which the C side takes as given and checks.

    ``op="rmw"``: the cells as one flat run: ``head`` cells up to the first
    16-byte boundary (all of them where fewer than 8 reach it), a body of
    ``body_bytes`` (a multiple of 16) cut into ``chunks`` of ``chunk``
    bytes (the last shorter), chunk c to block c mod ``grid``, and ``tail``
    cells after it (fewer than 8).

    ``op="read"``: the columns cut into ``strips`` strips of ``strip``
    columns (the last narrower; at most STREAM_STRIP), each strip's M rows
    into ``ranges`` ranges of ``per_cta`` rows (the last fewer; at least
    STREAM_MIN_RANGE_ROWS where there are several), a block each: ``grid`` =
    strips x ranges blocks, block b taking strip b mod strips and range
    b // strips, at most ``ctas_per_sm`` x ``sms`` of them where the strips
    allow; ``rows_per_stage`` rows a stage (at most
    STREAM_MAX_SEGMENT_ROWS with several strips), each row's segment in a
    slot of ``pitch`` bytes (its 16-byte-aligned span), or, with one
    strip, the stage's rows as one span; ``blocks`` = ceil(M / 512) rows
    of partials.

    Both: ``stages`` of ``stage_bytes`` a block, ``smem_bytes`` of dynamic
    shared memory (STREAM_SMEM_HEAD + stages x stage_bytes), ``threads``
    a block (STREAM_THREADS consumers and a producer warp).
    """
    if offset % 2 or not 0 <= offset < 16:
        raise ValueError(f"a bfloat16 panel starts at an even offset mod 16, "
                         f"got {offset}")
    if M <= 0 or W <= 0:
        raise ValueError(f"empty panel {M} x {W}")
    if op == "rmw":
        cps, stages = _stages(STREAM_CHUNK, smem_optin)
        n = M * W
        head = min(n, (16 - offset) % 16 // 2)
        body = 2 * (n - head) // 16 * 16
        chunks = -(-body // STREAM_CHUNK)
        return {"op": op, "head": head, "body_bytes": body,
                "chunk": STREAM_CHUNK, "chunks": chunks,
                "tail": n - head - body // 2,
                "grid": max(1, min(chunks, cps * sms)), "ctas_per_sm": cps,
                "stages": stages, "stage_bytes": STREAM_CHUNK,
                "smem_bytes": STREAM_SMEM_HEAD + stages * STREAM_CHUNK,
                "threads": STREAM_BLOCK}
    if op != "read":
        raise ValueError(f"op must be 'rmw' or 'read', got {op!r}")
    strips = -(-W // STREAM_STRIP)
    strip = -(-W // strips)
    pitch = -(-2 * strip // 16) * 16 + 16
    rows = max(1, STREAM_STAGE_BYTES // pitch)
    if strips > 1:
        rows = min(rows, STREAM_MAX_SEGMENT_ROWS)
    cps, stages = _stages(rows * pitch, smem_optin)
    ranges = max(1, min(cps * sms // strips, M // STREAM_MIN_RANGE_ROWS))
    per_cta = -(-M // ranges)
    ranges = -(-M // per_cta)
    return {"op": op, "strip": strip, "strips": strips, "pitch": pitch,
            "rows_per_stage": rows, "per_cta": per_cta, "ranges": ranges,
            "grid": strips * ranges,
            "blocks": -(-M // BLOCK_ROWS), "ctas_per_sm": cps,
            "stages": stages, "stage_bytes": rows * pitch,
            "smem_bytes": STREAM_SMEM_HEAD + stages * rows * pitch,
            "threads": STREAM_BLOCK}


def _ring_plan(R: torch.Tensor, op: str) -> dict:
    M, W = R.shape
    smem_optin, sms = gather_limits(R.device)
    return stream_plan(M, W, R.data_ptr() % 16, smem_optin, sms, op=op)


def stream_rmw(R: torch.Tensor, *, vec16: bool = False) -> torch.Tensor:
    """P1/P2 rmw: R += 1 in bfloat16, in place; returns R. The ring
    (``stream_plan``), or with ``vec16`` 16-byte vectors."""
    M, W = _check_panel(R)
    plan = None if vec16 else _ring_plan(R, "rmw")
    if R.device.type == "cpu":
        return stream_rmw_plain(R)
    from .build import load
    fn = load("probe_kernels").crtpu_stream_rmw
    if vec16:
        _launch(fn, _ptr(R), M, W, 1, 0, 0, 0, 0, _stream(R))
    else:
        _launch(fn, _ptr(R), M, W, 0, plan["head"], plan["chunk"],
                plan["stages"], plan["grid"], _stream(R))
    count("stream_rmw_vec16" if vec16 else "stream_rmw")
    return R


def stream_read(R: torch.Tensor, u: torch.Tensor | None = None, *,
                vec16: bool = False) -> torch.Tensor:
    """P1 read (with ``u``, (M,) float32) or P2's NaN-skip read floor
    (without); the ring (``stream_plan``), or with ``vec16`` 16-byte
    vectors. Returns g, (W,) float32."""
    M, W = _check_panel(R)
    if u is not None and (u.dtype != torch.float32 or u.shape != (M,)
                          or u.device != R.device or not u.is_contiguous()):
        raise ValueError(f"u must be contiguous float32 of shape ({M},) on "
                         f"{R.device}")
    plan = None if vec16 else _ring_plan(R, "read")
    if R.device.type == "cpu":
        return stream_read_plain(R, u)
    from .build import load
    opts = dict(dtype=torch.float32, device=R.device)
    g = torch.empty(W, **opts)
    gpart = torch.empty((-(-M // BLOCK_ROWS), W), **opts)
    args = [_ptr(R), None if u is None else _ptr(u), _ptr(gpart)]
    if vec16:
        args += [None, _ptr(g), M, W, 1, 0, 0, 0, 0, 0]
    else:
        gextra = (torch.empty((plan["grid"], plan["strip"]), **opts)
                  if plan["ranges"] > 1 else None)
        args += [None if gextra is None else _ptr(gextra), _ptr(g), M, W, 0,
                 plan["strip"], plan["rows_per_stage"], plan["stages"],
                 plan["grid"], plan["per_cta"]]
    _launch(load("probe_kernels").crtpu_stream_read, *args, _stream(R))
    count("stream_read_vec16" if vec16 else "stream_read")
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


def gather_limits(device: torch.device) -> tuple[int, int]:
    """(opt-in shared memory a block, SMs) that ``gather_plan`` and
    ``stream_plan`` take for ``device``: a CUDA device's, read once a
    device through the kernel library; the H100's for the CPU (whose plain
    version has no limit of its own)."""
    if device.type != "cuda":
        return H100_SMEM_OPTIN, H100_SMS
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
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
