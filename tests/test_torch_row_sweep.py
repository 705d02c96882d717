"""The row sweep's plan (K2 ``panel_usweep`` and ``masked_usweep``,
``ops/panel_kernels.py::row_sweep_plan``; the CUDA kernel is
``csrc/panel_kernels.cu::row_sweep_kernel``) on the CPU: every cell of
every row in exactly one segment and one block, the segments a function
of the width, the cell size and the offset alone, the headline's and the
dense path's widths one segment, the short, wide Yahoo panels spread over
the card; the kernel's lane and row arithmetic, mirrored in NumPy, touching
every cell once; the C constants and the plan's; and the wrappers' CPU path.
The kernel itself runs only on the card (chip_smoke.py phases 3, 11, 42)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.ops import panel_kernels as pk
from cuda_recommender_tpu_torch.ops.probe_kernels import H100_SMS

#: the Yahoo stairs' panels (rows, width: cuda_recommender_tpu_torch/
#: results/yahoo_robustness.jsonl), the headline's two, the dense path's
#: residual and small and ragged shapes
R1_T = [(912, 1_948_883), (336, 1_158_784), (1416, 487_168),
        (1488, 289_664), (5328, 172_288), (11_880, 51_200),
        (21_984, 21_504), (54_867, 10_752)]
C15_T = [(960, 1_000_990), (1440, 707_840), (3040, 210_432),
         (8000, 74_368), (21_120, 26_368), (64_160, 11_008),
         (84_160, 4_608), (442_081, 1_920)]
HEADLINE = [(330_128, 17_770), (150_061, 4_096)]
ML10M = (69_878, 10_677)
SMALL = [(1, 1), (3, 7), (5, 70_001)]
SHAPES = R1_T + C15_T + HEADLINE + [ML10M] + SMALL
#: cell sizes and the first cell's offsets a residual of each can have
OFFSETS = {4: (0, 4, 8, 12), 2: (0, 2, 6, 14), 1: (0, 1, 3, 7)}
CASES = [(M, W, cb, off) for M, W in SHAPES for cb in OFFSETS
         for off in OFFSETS[cb]]


def row_shift(plan, cb, off, r, W):
    """Row r's shift: where its first cell lies in its first unit, in
    cells (the residual's first cell ``off`` bytes past a boundary)."""
    return (off + r * W * cb) % plan["unit"] // cb


def row_segment(plan, shift, seg, W):
    """The columns [c0, c1) of segment ``seg`` of a row of width W and
    ``shift`` (empty where the row ends before it)."""
    c0 = seg * plan["segment_cells"] - shift
    return max(0, c0), max(0, min(W, c0 + plan["segment_cells"]))


def group_rows(plan, M, grp):
    """The rows of row group ``grp``: of class q = grp % interleave, the
    class's rows n (grp // interleave) to n (grp // interleave + 1), n =
    ROW_BLOCK_ROWS."""
    inter, n = plan["interleave"], pk.ROW_BLOCK_ROWS
    q, i0 = grp % inter, grp // inter * n
    n = max(0, min(n, -(-(M - q) // inter) - i0))
    return range(q + inter * i0, q + inter * (i0 + n), inter)


def _shifts(plan, cb, off, M, W):
    """Each row class's shift (the rows q, q + interleave, ...)."""
    return [row_shift(plan, cb, off, q, W)
            for q in range(min(M, plan["interleave"]))]


@pytest.mark.parametrize("M,W,cb,off", CASES)
def test_plan_covers_every_cell_once(M, W, cb, off):
    """Each row's segments cover its columns [0, W) without overlap, the
    row groups hold every row once, and the rows of a group share their
    shift."""
    plan = pk.row_sweep_plan(M, W, cb, off)
    assert 1 <= plan["chunks"] <= pk.ROW_SPAN_CHUNKS
    assert plan["spans"] == -(-plan["runs"] // pk.ROW_SPAN_RUNS)
    assert plan["segments"] == -(-plan["spans"] // plan["segment_spans"])
    for q, s in enumerate(_shifts(plan, cb, off, M, W)):
        assert 0 <= s <= plan["max_shift"]
        cuts = [row_segment(plan, s, k, W)
                for k in range(plan["segments"])]
        assert cuts[0][0] == 0 and cuts[-1][1] == W
        for (a0, a1), (b0, b1) in zip(cuts, cuts[1:]):
            assert a1 == b0 or (a0 == a1 == b0 == b1 == W)
        # a row's shift repeats every interleave rows
        r = q + plan["interleave"] * (M // plan["interleave"])
        assert row_shift(plan, cb, off, r, W) == s
    if M * plan["groups"] <= 5e8:
        rows = np.concatenate([np.asarray(group_rows(plan, M, g))
                               for g in range(plan["groups"])])
        assert np.array_equal(np.sort(rows), np.arange(M))
        assert len(rows) == M


@pytest.mark.parametrize("W", [1, 7, 1_920, 10_677, 17_770, 70_001,
                               1_948_883])
@pytest.mark.parametrize("cb", [1, 2, 4])
def test_segments_depend_on_width_not_rows(W, cb):
    """The segments, chunks and spans follow W, the cell size and the
    offset; the row count moves only the groups."""
    keys = ("interleave", "max_shift", "runs", "chunks", "spans",
            "segment_spans", "segment_cells", "segments")
    plans = [pk.row_sweep_plan(M, W, cb, 0) for M in (1, 63, 912, 330_128)]
    for p in plans[1:]:
        assert {k: p[k] for k in keys} == {k: plans[0][k] for k in keys}
    assert [p["groups"] for p in plans] == sorted(p["groups"] for p in plans)


@pytest.mark.parametrize("M,W,cb", [(*HEADLINE[0], 2), (*HEADLINE[0], 1),
                                    (*HEADLINE[1], 2), (*ML10M, 4),
                                    (*ML10M, 2), (*ML10M, 1)])
def test_headline_and_dense_widths_are_one_segment(M, W, cb):
    """The headline's panels (bf16, fp8) and the dense path's residual
    (f32, bf16, fp8) are one segment at every offset: the kernel writes
    g and h straight, with no partials and no counters."""
    for off in OFFSETS[cb]:
        plan = pk.row_sweep_plan(M, W, cb, off)
        assert plan["segments"] == 1
        assert plan["segment_spans"] == plan["spans"]


@pytest.mark.parametrize("M,W", R1_T[:5] + C15_T[:4])
def test_short_wide_panels_fill_the_card(M, W):
    """The short, wide panels (the old grid gave them fewer blocks than
    the card has SMs) get at least 4 warps an SM on 132 SMs, r1_t's panel
    0 many more, and segments of one span."""
    plan = pk.row_sweep_plan(M, W, 2)
    warps = plan["grid"] * pk.ROW_WARPS / H100_SMS
    assert warps >= 4
    assert plan["segments"] > 1 and plan["segment_spans"] == 1
    assert plan["segments"] == plan["spans"] > pk.ROW_SEGMENT_SPANS
    if (M, W) == R1_T[0]:
        assert plan["grid"] == 238 * 32 and warps >= 4 * 8
    assert -(-M // pk.ROW_WARPS) < plan["grid"]     # the old grid


def ragged_item(plan, W, shift, span, ch):
    """Whether row_sweep_kernel sums the item (span, chunk ch) of a row of
    ``shift`` again with the cells outside the row zeroed, where its sums
    come out NaN: the item holds the row's first run or the run of its
    last cell."""
    run0 = span * pk.ROW_SPAN_RUNS + ch * pk.ROW_CHUNK_RUNS
    last_run = (W - 1 + shift) // pk.ROW_RUN_CELLS
    return run0 == 0 or run0 <= last_run < run0 + pk.ROW_CHUNK_RUNS


def _kernel_cells(plan, M, W, cb, off):
    """The (row, column) cells row_sweep_kernel's lanes sum, each as
    often as it is summed, by the kernel's own arithmetic: block b takes
    segment b % segments of group b // segments (all the spans where a row
    is one segment, else span b % segments); for each span of its segment,
    item k (row k // nch, chunk k % nch; nch the span's live chunks) is
    warp k % 8's, in batches of 128 bytes a lane (f32 1 item, bf16 2, fp8
    4); lane l of an item holds the runs span 1024 + chunk 128 + l + 32 j,
    j < 4, each 8 columns from 8 run - shift, those inside [0, W). Also
    returns the runs that hold cells of the row and cells outside it in an
    item that cannot take the slow path (``ragged_item``)."""
    counts = np.zeros((M, W), np.int64)
    unzeroed = 0
    inter, batch = plan["interleave"], {4: 1, 2: 2, 1: 4}[cb]
    lane = np.arange(32)[:, None, None]
    j = np.arange(pk.ROW_RUNS)[None, :, None]
    e = np.arange(pk.ROW_RUN_CELLS)[None, None, :]
    for blk in range(plan["grid"]):
        seg, grp = blk % plan["segments"], blk // plan["segments"]
        q = grp % inter
        i0 = grp // inter * pk.ROW_BLOCK_ROWS
        nrows = min(pk.ROW_BLOCK_ROWS, -(-(M - q) // inter) - i0)
        if nrows <= 0:
            continue
        shift = (off + q * W * cb) % plan["unit"] // cb
        one = plan["segments"] == 1
        for span in range(0 if one else seg,
                          plan["spans"] if one else seg + 1):
            nch = pk.span_chunks(plan["runs"], span)
            items = nrows * nch
            for w in range(pk.ROW_WARPS):
                for k in range(w, items, pk.ROW_WARPS * batch):
                    for b in range(batch):
                        kb = k + b * pk.ROW_WARPS
                        if kb >= items:
                            break
                        ii, ch = divmod(kb, nch)
                        run = (span * pk.ROW_SPAN_RUNS
                               + ch * pk.ROW_CHUNK_RUNS + lane + 32 * j)
                        cols = pk.ROW_RUN_CELLS * run - shift + e
                        inside = (cols >= 0) & (cols < W)
                        np.add.at(counts[q + inter * (i0 + ii)],
                                  cols[inside], 1)
                        if not ragged_item(plan, W, shift, span, ch):
                            unzeroed += int((inside.any(-1)
                                             & ~inside.all(-1)).sum())
    return counts, unzeroed


@pytest.mark.parametrize("M,W", [(1, 1), (3, 7), (9, 3), (19, 257),
                                 (70, 1_031), (5, 8_193), (3, 24_577),
                                 (2, 70_001)])
@pytest.mark.parametrize("cb,off", [(4, 4), (2, 0), (2, 6), (1, 3)])
def test_kernel_arithmetic_sums_every_cell_once(M, W, cb, off):
    """The kernel's index arithmetic (mirrored in NumPy) sums every cell
    of every row exactly once, for one segment and for several, a
    ragged last one among them, at every live chunk count; and every run
    that holds cells of another row lies in an item that can take the
    slow path."""
    plan = pk.row_sweep_plan(M, W, cb, off)
    counts, unzeroed = _kernel_cells(plan, M, W, cb, off)
    assert (counts == 1).all()
    assert unzeroed == 0


@pytest.mark.parametrize("M,W,cb", [(*R1_T[0], 2), (*C15_T[0], 1),
                                    (*HEADLINE[0], 2), (*HEADLINE[0], 1),
                                    (*ML10M, 4), (*ML10M, 2), (*ML10M, 1),
                                    (5, 70_001, 2)])
def test_each_row_has_at_most_two_end_items(M, W, cb):
    """At every shift a row can have, the runs that straddle its ends
    (its first, where the shift is not 0, and the run of its last cell)
    lie in items that can take the slow path, and a row has at most two
    such items."""
    plan = pk.row_sweep_plan(M, W, cb)
    for shift in range(plan["unit"] // cb):
        ends = [0, (W - 1 + shift) // pk.ROW_RUN_CELLS]
        items = {(r // pk.ROW_SPAN_RUNS,
                  r % pk.ROW_SPAN_RUNS // pk.ROW_CHUNK_RUNS) for r in ends}
        for span, ch in items:
            assert ragged_item(plan, W, shift, span, ch)
        n = sum(ragged_item(plan, W, shift, span, ch)
                for span in range(plan["spans"])
                for ch in range(pk.span_chunks(plan["runs"], span)))
        assert n == len(items) <= 2


def test_row_constants_mirror_the_plan():
    """The kernel's constants (a lane's run, its runs of a chunk, a
    block's warps, a span's chunks, the spans of a one-segment row and a
    block's rows) are the plan's; the C side takes the plan's classes,
    runs, segments and groups and refuses any that leave a cell or a row
    out or break the segment rule; the kernel's slow path follows
    ``ragged_item``'s rule and only a NaN sum takes it."""
    src = (Path(pk.__file__).resolve().parent.parent / "csrc" /
           "panel_kernels.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert const("kColsPerThread") == pk.ROW_RUN_CELLS
    assert const("kRowRuns") == pk.ROW_RUNS
    assert const("kRowWarps") == pk.ROW_WARPS
    assert const("kSpanChunks") == pk.ROW_SPAN_CHUNKS
    assert const("kRowSegmentSpans") == pk.ROW_SEGMENT_SPANS
    assert const("kRowBlockRows") == pk.ROW_BLOCK_ROWS
    assert "constexpr int kChunkRuns = 32 * kRowRuns;" in src
    body = src[src.index("int launch_row_sweep("):]
    body = body[:body.index("\n}\n")]
    for check in ("W) * kSize * inter % kUnit != 0",
                  "runs) * kColsPerThread <",
                  "segments != (spans <= kRowSegmentSpans ? 1 : spans)",
                  "groups) * kRowBlockRows <"):
        assert check in body, check
    # no float atomics in the row sweep
    kern = src[src.index("row_sweep_kernel(const T*"):]
    kern = kern[:kern.index("\n}\n")]
    assert "atomicAdd(count + grp, 1u)" in kern
    assert not re.search(r"atomicAdd\((g|h|gpart|hpart)", kern)
    flat = " ".join(kern.split())
    assert "const int last_run = (W - 1 + shift) / kColsPerThread;" in flat
    assert ("if ((isnan(tot.x) || isnan(tot.y)) && (run0 == 0 || (last_run "
            ">= run0 && last_run < run0 + kChunkRuns))) tot = "
            "row_item_zeroed<T, MaskT>(") in flat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn])
@pytest.mark.parametrize("mask", [None, torch.bfloat16, torch.int8])
def test_cpu_wrappers_take_the_plain_versions(dtype, mask):
    """On CPU tensors the wrappers return their plain versions' sums and
    launch nothing, at a width of several segments."""
    rng = np.random.default_rng(3)
    M, W = 3, 30_001
    x = rng.normal(size=(M, W)).astype(np.float32)
    keep = rng.random((M, W)) < 0.3
    v = torch.from_numpy(rng.normal(size=W).astype(np.float32))
    launches.reset_launch_counts()
    if mask is None:
        R = torch.from_numpy(np.where(keep, x, np.nan)).to(dtype)
        got = pk.panel_usweep(R, v)
        want = pk.panel_usweep_plain(R, v)
    else:
        R = torch.from_numpy(np.where(keep, x, 0.0)).to(dtype)
        Mk = torch.from_numpy(keep).to(mask)
        got = ck.masked_usweep(R, Mk, v)
        want = ck.masked_usweep_plain(R, Mk, v)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert set(launches.launch_counts().values()) == {0}
    assert pk.row_sweep_plan(M, W, R.element_size())["segments"] > 1


def test_yahoo_profile_attributes_the_row_sweep_to_k2():
    """scripts/yahoo_robustness.py splits a profiled iteration by kernel
    name: every kernel of csrc/panel_kernels.cu lands in K1 or K2, the
    row sweep's (all its instances) in K2 alone, none in the tail."""
    from cuda_recommender_tpu_torch.scripts.profile_iteration import \
        kernel_split
    from cuda_recommender_tpu_torch.scripts.yahoo_robustness import \
        HYBRID_PARTS

    src = (Path(pk.__file__).resolve().parent.parent / "csrc" /
           "panel_kernels.cu").read_text()
    kernels = set(re.findall(r"__global__ void __launch_bounds__\([^;]*?\)"
                             r"\s*\)?\s*(\w+_kernel)\(", src, re.S))
    assert kernels == {"col_sweep_kernel", "col_reduce_kernel",
                       "row_sweep_kernel"}
    names = [f"void (anonymous namespace)::row_sweep_kernel<{t}, {m}>("
             f"{t} const*, {m} const*, float const*, float*, float*, "
             f"unsigned int*, float*, float*, int, int, int, int, int, int)"
             for t in ("float", "__nv_bfloat16",
                                    "(anonymous namespace)::Fp8")
             for m in ("(anonymous namespace)::NanMask", "__nv_bfloat16",
                       "signed char")]
    names += ["void (anonymous namespace)::col_sweep_kernel<__nv_bfloat16, "
              "(anonymous namespace)::NanMask, true>(int)",
              "(anonymous namespace)::col_reduce_kernel(float const*)"]
    trace = {"kernels": [(n, 1.0, 1) for n in names]}
    split = kernel_split(trace, HYBRID_PARTS, "tail_and_rest")
    assert split == {"K1": 2.0, "K2": 9.0, "tail_and_rest": 0.0}
