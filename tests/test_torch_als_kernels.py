"""The ALS gram assembly kernel's CPU side (ops/als_kernels.py).

On the CPU ``als_gram`` is its plain version, the port's gather of
Faug = [F | val] and f32 ``torch.bmm`` as they were before the kernel
(bit for bit). The kernel itself runs only on the card (chip_smoke.py holds
it to an f64 gram); here its index arithmetic is mirrored in NumPy from the
source's constants: the work items cover every real lane of every slot
exactly once and no padded lane, and the threads' register tiles cover the
gram's upper triangle exactly once at every k.
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_recommender_tpu_torch import Config
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.core.metrics_log import MetricsLog
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.ell import build_ell_pair
from cuda_recommender_tpu_torch.ops import als_kernels as ak
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.solvers import als_ell

SRC = (Path(ak.__file__).resolve().parent.parent / "csrc" /
       "als_kernels.cu").read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _layout(min_width="auto", k=8, seed=3):
    R, _ = datasets.synthetic(m=400, n=150, nnz=9000, seed=seed)
    ell = build_ell_pair(R, min_width=min_width)
    rng = np.random.default_rng(seed)
    other = {name: torch.from_numpy(rng.uniform(
        -1, 1, (side.n_slots, k)).astype(np.float32))
        for name, side in (("rows", ell.cols_side), ("cols", ell.rows_side))}
    return ell, other


def _groups(ell, other):
    """Every (bucket, row group) of both sides at a small group budget:
    (bucket, idx, val, counts, the other side's factors)."""
    k = next(iter(other.values())).shape[1]
    for name, side in (("rows", ell.rows_side), ("cols", ell.cols_side)):
        nnz = torch.from_numpy(side.slot_nnz)
        for b, off in zip(side.buckets, side.bucket_offsets):
            idx = torch.from_numpy(b.idx.astype(np.int64))
            val = torch.from_numpy(b.val)
            for r0, r1 in als_ell._row_groups(b.rows, b.L, b.p, k, 1 << 16):
                yield (b, idx[r0:r1], val[r0:r1],
                       nnz[off + r0 * b.p:off + r1 * b.p], other[name])


def _old_gram(idx, val, other, b):
    """The assembly before the kernel: the (n+1, k+1) augmented table,
    ``table[idx]``, the ratings into column k, one f32 bmm."""
    n, k = other.shape
    table = other.new_zeros((n + 1, k + 1))
    table[:n, :k] = other
    S = idx.shape[0] * b.p
    f = table[idx.reshape(S, b.E)]
    f[:, :, k] = val.reshape(S, b.E)
    return torch.bmm(f.transpose(1, 2).float(), f.float())


@pytest.mark.parametrize("min_width", [8, "auto"])
def test_cpu_is_the_plain_version_bit_for_bit(min_width):
    """Every bucket and row group of both sides, lane-packed ones among
    them: ``als_gram`` == ``als_gram_plain`` == the old gather + bmm, and
    ``_gram_and_rhs`` at "highest" returns its views; no launch counted."""
    ell, other = _layout(min_width)
    launches.reset_launch_counts()
    ps = set()
    for b, idx, val, counts, oth in _groups(ell, other):
        ps.add(b.p)
        got = ak.als_gram(idx, val, counts, oth, b.E, b.p)
        want = _old_gram(idx, val, oth, b)
        assert got.dtype == torch.float32
        assert torch.equal(got, want)
        assert torch.equal(got, ak.als_gram_plain(idx, val, counts, oth,
                                                  b.E, b.p))
        k = oth.shape[1]
        G, r = als_ell._gram_and_rhs(idx, val, counts, (oth,), b, k,
                                     "highest")
        assert torch.equal(G, want[:, :k, :k])
        assert torch.equal(r, want[:, :k, k])
    assert max(ps) > 1
    assert launches.launch_counts()["als_gram"] == 0


def test_gram_tables_highest_is_the_factor_table():
    """"highest" gathers nothing apart: its table is the factors
    themselves, with no augmented copy."""
    x = torch.randn(7, 5)
    (t,) = als_ell.gram_tables(x, "highest")
    assert t is x


def _operands(k=8, E=4, p=2, rows=3, n=10, dtype=torch.float32):
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, n, (rows, E * p)))
    val = torch.from_numpy(rng.uniform(1, 5, (rows, E * p))).to(dtype)
    counts = torch.full((rows * p,), float(E), dtype=dtype)
    other = torch.from_numpy(rng.uniform(-1, 1, (n, k))).to(dtype)
    return idx, val, counts, other, E, p


@pytest.mark.parametrize("case", ["f64_val", "f64_other", "f64_counts",
                                  "k0", "k129", "strided_other",
                                  "int32_idx", "bad_width", "bad_counts",
                                  "wide_bucket"])
def test_refuses_what_the_kernel_does_not_take(case):
    idx, val, counts, other, E, p = _operands()
    if case == "f64_val":
        val = val.double()
    elif case == "f64_other":
        other = other.double()
    elif case == "f64_counts":
        counts = counts.double()
    elif case == "k0":
        other = other[:, :0].contiguous()
    elif case == "k129":
        other = torch.zeros((other.shape[0], 129))
    elif case == "strided_other":
        other = torch.zeros((other.shape[0], 16))[:, ::2]
        assert not other.is_contiguous()
    elif case == "int32_idx":
        idx = idx.int()
    elif case == "bad_width":
        E = E + 1
    elif case == "bad_counts":
        counts = counts[:-1]
    elif case == "wide_bucket":
        E = ak.MAX_E + 1
    with pytest.raises((TypeError, ValueError)):
        ak.als_gram(idx, val, counts, other, E, p)


def _cover(counts, E):
    """Each slot's lanes as the work items cover them: a (slots, E) count
    of visits from ``segment_plan``."""
    slot, first, lanes = ak.segment_plan(counts, E)
    assert np.all(lanes >= 0) and np.all(lanes <= ak.SEGMENT_LANES)
    m = ak.segments(E)
    assert slot.size == counts.size * m
    assert np.array_equal(slot, np.repeat(np.arange(counts.size), m))
    seen = np.zeros((counts.size, E), np.int64)
    for s, a, n in zip(slot, first, lanes):
        seen[s, a:a + n] += 1
    return seen


@pytest.mark.parametrize("E,counts", [
    # the lane-packed bucket of Yahoo's rows side (p = 4)
    (32, [32, 31, 17, 1, 0, 0, 0, 0]),
    # the auto floors of ml20m's two sides
    (77, [77, 76, 40, 0]),
    (325, [325, 300, 200]),
    # around the segment length, and a heavy item of 1.2 M ratings
    (2048, [2048, 2047, 1]),
    (2049, [2049, 2048, 1, 0]),
    (1_200_000, [1_200_000, 1_199_999, 700_001, 2049, 0]),
])
def test_segment_plan_covers_real_lanes_once(E, counts):
    counts = np.asarray(counts, np.float32)
    seen = _cover(counts, E)
    real = np.arange(E)[None, :] < counts[:, None]
    assert np.all(seen[real] == 1)          # every real lane exactly once
    assert np.all(seen[~real] == 0)         # no padded lane
    assert ak.launches_per_call(E) == (2 if E > ak.SEGMENT_LANES else 1)


def test_segment_plan_on_the_layout_counts():
    """The counts of a real layout (``slot_nnz``) at both sides' buckets:
    every rating a lane of exactly one item."""
    ell, _ = _layout(8)
    for side in (ell.rows_side, ell.cols_side):
        for b, off in zip(side.buckets, side.bucket_offsets):
            counts = side.slot_nnz[off:off + b.rows * b.p]
            seen = _cover(counts, b.E)
            assert seen.sum() == counts.sum()
            assert np.all(b.val.reshape(-1, b.E)[seen == 0] == 0)
            assert np.all(b.idx.reshape(-1, b.E)[seen == 0]
                          == side.other_zero_slot)


def _tiles(k):
    """The kernel's thread -> tile map at k (csrc/als_kernels.cu): (T, P,
    threads, [(ti, tj, active)])."""
    tile = _const("kTile")
    T = -(-(k + 1) // tile)
    P = -(-(tile * T) // 4) * 4
    n = T * (T + 1) // 2
    threads = -(-n // 32) * 32
    out = []
    for t in range(threads):
        ti, rem = 0, t
        while ti < T and rem >= T - ti:
            rem -= T - ti
            ti += 1
        active = ti < T
        if not active:
            ti, rem = T - 1, 0
        out.append((ti, ti + rem, active))
    return T, P, threads, out


@pytest.mark.parametrize("k", range(1, 129))
def test_register_tiles_cover_the_gram_once(k):
    """Every entry (row, col) of the (k+1)^2 gram is stored exactly once:
    from the upper tile that holds it or, below the diagonal, from the
    mirror of one; each register reads the staged column it stands for
    (the odd tiles' rotation by 2), inside the row of P floats, its
    16-byte load 16-byte aligned; the block and its shared memory fit."""
    tile, lanes, stages = _const("kTile"), _const("kStageLanes"), \
        _const("kStages")
    T, P, threads, tiles = _tiles(k)
    assert threads <= _const("kMaxThreads") and P % 4 == 0 and P >= k + 1
    assert stages * lanes * (P * 4 + 8) <= 48 * 1024   # no opt-in needed
    stored = np.zeros((k + 1, k + 1), np.int64)
    for ti, tj, active in tiles:
        assert ti <= tj < T
        for t_ in (ti, tj):
            q = tile * t_ + (2 if t_ & 1 else 0)      # 16-byte operand
            d = tile * t_ + (0 if t_ & 1 else 4)      # 8-byte operand
            assert q % 4 == 0 and d % 2 == 0 and max(q + 4, d + 2) <= P
            regs = [q, q + 1, q + 2, q + 3, d, d + 1]
            rot = 2 if t_ & 1 else 0
            assert [tile * t_ + (i + rot) % tile for i in range(tile)] == \
                regs
        if not active:
            continue
        for a in range(tile):
            for c in range(tile):
                row, col = tile * ti + a, tile * tj + c
                if row <= k and col <= k:
                    stored[row, col] += 1
                    if ti != tj:
                        stored[col, row] += 1
    assert np.all(stored == 1)


def test_launch_registry_and_plan_report_the_kernel(tmp_path):
    """``ops/launches.py`` counts ``als_gram``; the ``als_plan`` event
    reports each side's assembled and skipped lanes, its split slots and
    segments, and the kernel's launches an iteration."""
    assert "als_gram" in launches.launch_counts()
    R, T = datasets.synthetic(m=400, n=150, nnz=9000, seed=3)
    k = 4
    cfg = Config(solver="als", k=k, lambda_=0.1, maxiter=1,
                 als_precision="highest")
    W0, H0 = init_factors_np(k, R.rows, R.cols, seed=0, entity_major=True)
    path = tmp_path / "m.jsonl"
    log = MetricsLog(str(path))
    try:
        als_ell.als_ell_train(R, W0, H0, T, cfg, device="cpu", log=log)
    finally:
        log.close()
    plan = [e for e in map(json.loads, path.read_text().splitlines())
            if e["kind"] == "als_plan"][0]
    ell = build_ell_pair(R, min_width=cfg.als_min_width)
    for name, side in (("rows", ell.rows_side), ("cols", ell.cols_side)):
        p = plan["sides"][name]
        assert p["assembled_lanes"] == R.nnz
        assert p["assembled_lanes"] + p["skipped_pad_lanes"] == \
            p["padded_lanes"] == side.nnz_padded
        assert p["split_slots"] == p["segments"] == 0   # every E <= 2048
    assert plan["als_gram_launches_per_iter"] == \
        als_ell.als_gram_launches_per_iter(ell, k, cfg.als_group_mb << 20) \
        == plan["k5_launches_per_iter"]
    assert als_ell.als_gram_launches_per_iter(
        ell, k, cfg.als_group_mb << 20, "default") == 0


def test_split_slots_reported_for_wide_buckets():
    """A side with a bucket wider than the segment length: its slots are
    split slots, ``segments(E)`` each, and each of its row groups launches
    twice (the segments, then their sum)."""
    from cuda_recommender_tpu_torch.data.sparse import from_coo

    degrees = np.array([5000, 3000, 10, 3])
    cols = np.concatenate([np.arange(d) for d in degrees])
    rows = np.repeat(np.arange(degrees.size), degrees)
    R = from_coo(degrees.size, 5000, rows, cols,
                 np.ones(rows.size, np.float32))
    ell = build_ell_pair(R, min_width=8)
    p = als_ell._side_plan(ell.rows_side, 8, 4, 1 << 31, "highest")
    wide = [b for b in ell.rows_side.buckets if b.E > ak.SEGMENT_LANES]
    assert wide
    assert p["split_slots"] == sum(b.rows * b.p for b in wide)
    assert p["segments"] == sum(b.rows * b.p * ak.segments(b.E)
                                for b in wide)
    assert p["assembled_lanes"] == R.nnz
