"""Port probe kernels (P1-P3) against the JAX package's measurement scripts.

The same NumPy-seeded inputs go through the Pallas bodies of
``scripts/panel_floor.py`` (P1: ``_rmw_kernel``, ``_read_kernel``),
``scripts/panel_kernel_variants.py`` (P2: ``_rmw_kernel``, ``_read_kernel``,
``_uv_kernel_astype`` through ``run_uv_variant``) and
``scripts/probe_vmem_gather.py`` (P3: ``kernel_take``, ``kernel_fancy``,
``kernel_rowloop``), each in a ``pl.pallas_call`` with the script's
BlockSpecs and ``interpret=True`` (the scripts' own calls take no
interpret flag), and through the plain versions of
``cuda_recommender_tpu_torch/ops/probe_kernels.py`` and
``ops/panel_kernels.py``, which the CPU wrappers take and which are the CUDA
kernels' oracle on the card (chip_smoke.py phase 18). Bars: the rmw and the
gathers bit-equal; the column sums within 1e-5 of Σ|terms| (f32 sums in
another order); the rounding variant's stored residual bit-equal, g and h
within 1e-5 of Σ|terms|. The NaN sentinel's bits follow each framework's
f32 -> bf16 conversion (JAX writes 0x7FC0, this torch's CPU 0xFFFF), so
against JAX a stored NaN must be NaN at the same cell; against the port's
own K1 every bit is equal.

The read's host logic is held here too: ``read_plan``'s work split (every
cell read once, every 512-row block in one thread block's range, one wave
of balanced ranges) and its fixed order of additions, which
``stream_read_in_order`` repeats on the host: against the plain version
and the Pallas bodies within 1e-5 of Σ|terms| (the smoke holds the kernel
bit-equal to it on the card); and the kernel's NaN test on pair words, on
every bf16 bit pattern. P3's host logic too: ``gather_plan``'s choice of
path and kernel at the bench's shapes and at the shared-memory limit, its
split of the index around the output's 16-byte boundaries, and the
wrapper's refusals; the kernels themselves run only on the card
(chip_smoke.py).

Importing the scripts sets three JAX compilation-cache options (and puts
the repository on sys.path); the fixture restores them.
"""

import importlib.util
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cuda_recommender_tpu_torch.ops import build, launches
from cuda_recommender_tpu_torch.ops import panel_kernels as pk
from cuda_recommender_tpu_torch.ops import probe_kernels as pr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE_KEYS = ("jax_compilation_cache_dir",
              "jax_persistent_cache_min_entry_size_bytes",
              "jax_persistent_cache_min_compile_time_secs")
BM = pr.BLOCK_ROWS         # the probes' block height (panel_pallas.BM)
RTOL = 1e-5


@pytest.fixture(scope="module")
def scripts():
    """The three JAX measurement scripts, loaded from their files with the
    JAX config and sys.path as they were before."""
    saved = {key: getattr(jax.config, key) for key in CACHE_KEYS}
    path = list(sys.path)
    out = {}
    try:
        for name in ("panel_floor", "panel_kernel_variants",
                     "probe_vmem_gather"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_script_{name}", os.path.join(ROOT, "scripts",
                                                    f"{name}.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out[name] = mod
    finally:
        for key, val in saved.items():
            jax.config.update(key, val)
        sys.path[:] = path
    return out


def test_fixture_restores_jax_config(scripts):
    """The scripts set these two to -1 and 0 when imported."""
    assert jax.config.jax_persistent_cache_min_entry_size_bytes != -1
    assert jax.config.jax_persistent_cache_min_compile_time_secs != 0


def _panel(M, W, seed, nan_frac=0.0):
    rng = np.random.default_rng(seed)
    R = rng.normal(size=(M, W)).astype(np.float32)
    if nan_frac:
        R[rng.random((M, W)) < nan_frac] = np.nan
    return R


def _bf16(x):
    """(jax bf16 array, torch bf16 tensor) of the same f32 values."""
    j = jnp.asarray(x).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _jbits(x):
    return np.array(jax.lax.bitcast_convert_type(x, jnp.int16))


def _tbits(x):
    return x.view(torch.int16).numpy()


def _close(got, want, scale):
    got, want, scale = (np.asarray(a, np.float64) for a in (got, want, scale))
    assert np.all(np.abs(got - want) <= RTOL * scale + 1e-30), \
        float(np.max(np.abs(got - want) / np.maximum(scale, 1e-30)))


# ---------------------------------------------------------------- P1 / P2 rmw

def _rmw_call(kernel, Rd, bm, bw, rowmajor):
    """panel_floor.rmw_call with the block (bm, bw) and interpret=True."""
    Mp, Wp = Rd.shape
    if rowmajor:
        grid = (Mp // bm, Wp // bw)
        spec = pl.BlockSpec((bm, bw), lambda im, jw: (im, jw))
    else:
        grid = (Wp // bw, Mp // bm)
        spec = pl.BlockSpec((bm, bw), lambda jw, im: (im, jw))
    return pl.pallas_call(kernel, grid=grid, in_specs=[spec], out_specs=spec,
                          out_shape=jax.ShapeDtypeStruct(Rd.shape, Rd.dtype),
                          input_output_aliases={0: 0}, interpret=True)(Rd)


@pytest.mark.parametrize("script", ["panel_floor", "panel_kernel_variants"])
@pytest.mark.parametrize("rowmajor", [False, True])
@pytest.mark.parametrize("M,W", [(1024, 256), (512, 384)])
def test_rmw_matches_pallas(scripts, script, rowmajor, M, W):
    """Both scripts' rmw bodies, both grid orders, against the port's one
    rmw (the function is per cell, so the order is no parameter of it):
    bit-equal."""
    x = _panel(M, W, seed=M + W) * np.float32(300.0)    # bf16 ties at |x| > 256
    j, t = _bf16(x)
    want = _rmw_call(scripts[script]._rmw_kernel, j, BM, 128, rowmajor)
    launches.reset_launch_counts()
    got = pr.stream_rmw(t)
    assert got is t                                    # in place
    assert launches.launch_counts()["stream_rmw"] == 0   # CPU: plain
    np.testing.assert_array_equal(_tbits(got), _jbits(want))


@pytest.mark.parametrize("M,W", [(37, 53), (1024, 256)])
def test_rmw_plain_formula_ragged(M, W):
    """Each cell becomes bf16(f32(x) + 1), once: on a ragged (M, W), on a
    block-multiple one, and on a view whose first cell is 2 W bytes into
    its buffer (off a 16-byte boundary where 2 W is not a multiple of 16).
    On the CPU: the plain version, no launch."""
    x = _panel(M, W, seed=M + 3) * np.float32(1000.0)
    _, t = _bf16(x)
    want = (t.to(torch.float32) + 1.0).to(torch.bfloat16)
    launches.reset_launch_counts()
    np.testing.assert_array_equal(_tbits(pr.stream_rmw(t.clone())),
                                  _tbits(want))
    view = t.clone()[1:]
    np.testing.assert_array_equal(_tbits(pr.stream_rmw(view)),
                                  _tbits(want[1:]))
    assert set(launches.launch_counts().values()) == {0}


# ------------------------------------------------------------ the read's plan

#: read_plan's shapes: the bench's two panels, the variant matrix's, and
#: ragged small ones (3 x 5 has fewer cells than two 16-byte vectors, 1 x 7
#: fewer than one)
PLAN_SHAPES = ((330_128, 17_770), (150_061, 4_096), (165_376, 18_432),
               (37, 53), (3, 5), (1, 7))
OFFSETS = range(0, 16, 2)


@pytest.mark.parametrize("off", OFFSETS)
@pytest.mark.parametrize("M,W", PLAN_SHAPES)
def test_read_plan_covers_every_cell_once(M, W, off):
    """At the bench's panels, the variant matrix's and ragged small
    shapes, at every even offset of the first cell mod 16: the tiles cover
    the columns once, each tile's ranges cover its row blocks once (every
    512-row block in exactly one thread block's range, ranges within one
    row block of each other), the grid within one wave of the H100's
    resident blocks (or one range a tile), the aligned path only where
    every row starts on a 16-byte boundary, and each warp's rows at one
    offset."""
    plan = pr.read_plan(M, W, off)
    tiles, nb, ranges = plan["tiles"], plan["blocks"], plan["ranges"]
    cols = plan["tile_cols"]
    assert cols == pr.READ_TILE_COLS[plan["path"]]
    assert (tiles - 1) * cols < W <= tiles * cols
    assert nb == -(-M // BM) and 1 <= ranges <= nb
    assert plan["grid"] == tiles * ranges
    if plan["path"] == "aligned":             # the fullest single wave
        wave = pr.H100_READ_BLOCKS_PER_SM * pr.H100_SMS
        assert plan["grid"] <= wave or ranges == 1
        assert ranges == nb or (ranges + 1) * tiles > wave
    else:                               # short blocks, dispatched tile-fast
        assert ranges == -(-nb // pr.READ_SHIFT_ROW_BLOCKS)
    cover = np.zeros((tiles, nb), np.int64)
    sizes = []
    for b in range(plan["grid"]):
        tile, b0, b1 = pr.read_block(plan, b)
        assert 0 <= tile < tiles and 0 <= b0 < b1 <= nb
        cover[tile, b0:b1] += 1
        sizes.append(b1 - b0)
    assert np.all(cover == 1)
    assert max(sizes) - min(sizes) <= 1
    seen = np.zeros(W, np.int64)                  # a tile's columns
    for tile in range(tiles):
        seen[tile * cols:(tile + 1) * cols] += 1
    assert np.all(seen == 1)
    aligned = off == 0 and W % 8 == 0
    assert plan["path"] == ("aligned" if aligned else "shifted")
    rows = np.arange(min(M, 4 * BM))
    starts = (off + 2 * rows * W) % 16        # each row's first byte mod 16
    for y, warp_off in enumerate(plan["warp_offsets"]):
        assert np.all(starts[rows % pr.READ_WARPS == y] == warp_off)
    assert aligned == (set(plan["warp_offsets"]) == {0} and W % 8 == 0)


@pytest.mark.parametrize("M,W", PLAN_SHAPES)
def test_read_plan_sums_in_a_fixed_order(M, W):
    """A tile's last block adds every range's sums once, in a fixed order:
    warp w the ranges w, w + 8, ... in increasing order, then the warps in
    order; the order depends on the number of ranges alone."""
    ranges = pr.read_plan(M, W)["ranges"]
    order = pr.read_sum_order(ranges)
    assert len(order) == pr.READ_WARPS
    assert sorted(k for warp in order for k in warp) == list(range(ranges))
    for w, warp in enumerate(order):
        assert list(warp) == sorted(warp)
        assert all(k % pr.READ_WARPS == w for k in warp)
    assert order == pr.read_sum_order(ranges)


def test_read_plan_balances_the_waves():
    """At 4 resident blocks an SM on 132 SMs (528 at once), on the aligned
    path: the bench's panel 1, 16 tiles of 294 row blocks, 33 ranges of 8
    or 9 (528 blocks, one wave); the variant matrix's 72 tiles of 323 row
    blocks, 7 ranges of 46 or 47 (504), where a 512-row block a thread
    block would be 4,704 and 23,256 blocks; at 8 an SM 66 and 14 ranges.
    On the shifted path (panel 0: 72 tiles of 248 columns, 645 row
    blocks) 162 ranges of 3 or 4 row blocks, whatever the occupancy."""
    for (M, W), want in (((150_061, 4_096), (16, 294, 33)),
                         ((165_376, 18_432), (72, 323, 7))):
        plan = pr.read_plan(M, W, 0, 132, 4)
        assert (plan["path"], plan["tiles"], plan["blocks"],
                plan["ranges"]) == ("aligned", *want)
        assert plan["grid"] <= 4 * 132
    assert [pr.read_plan(M, W, 0, 132, 8)["ranges"] for M, W in
            PLAN_SHAPES[1:3]] == [66, 14]
    for per_sm in (3, 4, 8):
        plan = pr.read_plan(330_128, 17_770, 0, 132, per_sm)
        assert (plan["path"], plan["tiles"], plan["blocks"],
                plan["ranges"]) == ("shifted", 72, 645, 162)
        sizes = {b1 - b0 for _, b0, b1 in (pr.read_block(plan, b)
                                           for b in range(plan["grid"]))}
        assert sizes == {3, 4}


def test_read_plan_refuses_what_is_not_a_panel():
    """An odd offset (not a bfloat16 address) or one of 16 and over, and
    an empty panel, raise."""
    for kwargs in ({"offset": 3}, {"offset": 16}, {"offset": -2}):
        with pytest.raises(ValueError, match="even offset"):
            pr.read_plan(8, 8, **kwargs)
    for M, W in ((0, 8), (8, 0)):
        with pytest.raises(ValueError, match="empty"):
            pr.read_plan(M, W)


def test_read_constants_mirror_the_plan():
    """The kernel's kRead* constants and row-block height are the plan's,
    and its C entry point refuses the aligned path off a 16-byte boundary
    or at a width that is not a multiple of 8."""
    src = (Path(pr.__file__).resolve().parent.parent / "csrc" /
           "probe_kernels.cu").read_text()

    def const(name):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        return int(m.group(1))

    assert const("kReadWarps") == pr.READ_WARPS
    assert 32 * const("kVecElems") == pr.READ_TILE_COLS["aligned"]
    assert 31 * const("kVecElems") == pr.READ_TILE_COLS["shifted"]
    assert "kShiftTileCols = kReadTileCols - kVecElems" in src
    assert const("kTileRows") == pr.BLOCK_ROWS
    body = src[src.index("int crtpu_stream_read("):]
    body = body[:body.index("\n}\n")]
    assert "if (aligned && ((reinterpret_cast<uintptr_t>(R) & 15) || " \
        "W % kVecElems))" in body
    assert "ranges > nb" in body


def test_stream_wrappers_take_the_plain_version_on_the_cpu():
    """On a CPU tensor (a view off a 16-byte boundary too) the wrappers
    take the plain versions and count nothing."""
    x = _panel(600, 90, seed=4) * np.float32(300.0)
    _, t = _bf16(x)
    want = pr.stream_rmw_plain(t.clone())
    launches.reset_launch_counts()
    view = t.clone().view(-1)[3:3 + 599 * 90].view(599, 90)
    assert torch.equal(_tbits_t(pr.stream_rmw(view)),
                       _tbits_t(want.view(-1)[3:3 + 599 * 90].view(599, 90)))
    g = pr.stream_read(view)
    assert torch.equal(g, pr.stream_read_plain(view))
    assert set(launches.launch_counts().values()) == {0}


def _tbits_t(x):
    return x.contiguous().view(torch.int16)


def test_zero_nan_pair_on_every_bf16():
    """The kernel's NaN test on a pair word (zero_nan_pair): in (w |
    0x80008000) - 0x7F817F81, bit 15 (31) is set exactly where the low
    (high) half is a bf16 NaN, for every 16-bit pattern of one half beside
    every pattern class of the other (no borrow across the halves)."""
    h = np.arange(1 << 16, dtype=np.uint32)
    nan = np.isnan((h << 16).view(np.float32))
    for other in (0x0000, 0x7F80, 0x7F81, 0x8000, 0xFFFF, 0x3F80):
        lo = ((h | (other << 16)) | 0x80008000) - 0x7F817F81
        np.testing.assert_array_equal((lo >> 15) & 1 == 1, nan)
        assert np.all(((lo >> 31) & 1 == 1) ==
                      np.isnan(np.uint32(other << 16).view(np.float32)))
        hi = (((h << 16) | other) | 0x80008000) - 0x7F817F81
        np.testing.assert_array_equal((hi >> 31) & 1 == 1, nan)
        assert np.all(((hi >> 15) & 1 == 1) ==
                      np.isnan(np.uint32(other << 16).view(np.float32)))


#: plans of stream_read_in_order: the H100's, and one range a row block
#: (the most ranges a plan may take)
def _plans(M, W):
    return [pr.read_plan(M, W), pr.read_plan(M, W, 0, 4 * M, 1)]


@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("M,W", [(1537, 300), (3, 2), (1100, 264),
                                 (2053, 17)])
def test_read_in_order_matches_plain(M, W, nan):
    """The kernel's order of additions (stream_read_in_order) under each
    plan against the plain version within 1e-5 of Σ|terms|: ragged rows and
    columns, under one 16-byte vector, several ranges a tile; NaN-skip with
    40% NaN; the same bits from one call to the next."""
    x = _panel(M, W, seed=M + W, nan_frac=0.4 if nan else 0.0)
    _, t = _bf16(x)
    u = None if nan else torch.from_numpy(
        np.random.default_rng(M).normal(size=M).astype(np.float32))
    scale = pr.stream_read_plain(t.abs(), None if u is None else u.abs())
    for plan in _plans(M, W):
        got = pr.stream_read_in_order(t, u, plan)
        assert np.isfinite(got.numpy()).all()
        _close(got.numpy(), pr.stream_read_plain(t, u).numpy(),
               scale.numpy())
        assert torch.equal(got, pr.stream_read_in_order(t, u, plan))


# ------------------------------------------------------------------- P1 read

def _read_call(kernel, Rd, u_row, bm, bw):
    """panel_floor.read_call with the block (bm, bw) and interpret=True."""
    Mp, Wp = Rd.shape
    return pl.pallas_call(
        kernel, grid=(Wp // bw, Mp // bm),
        in_specs=[pl.BlockSpec((bm, bw), lambda jw, im: (im, jw)),
                  pl.BlockSpec((1, bm), lambda jw, im: (0, im))],
        out_specs=pl.BlockSpec((1, bw), lambda jw, im: (0, jw)),
        out_shape=jax.ShapeDtypeStruct((1, Wp), jnp.float32),
        interpret=True)(Rd, u_row)


def _in_buffer(t, view):
    """t itself, or (view) a copy of it one row into a buffer of one row
    more (its first cell 2 W bytes past the buffer's)."""
    if not view:
        return t
    buf = torch.zeros((t.shape[0] + 1, t.shape[1]), dtype=t.dtype)
    buf[1:] = t
    return buf[1:]


@pytest.mark.parametrize("view", [False, True])
@pytest.mark.parametrize("M,W", [(1536, 256), (512, 128), (2048, 384)])
def test_read_matches_pallas(scripts, M, W, view):
    """P1's read: g[j] = Σ_b u[512 b] Σ_{i in b} R[i, j] (the weight is u at
    the block's first row, not a per-row matvec), through the wrapper and
    through the kernel's order of additions under each plan, also on a view
    one row into its buffer."""
    x = _panel(M, W, seed=M)
    u = np.random.default_rng(M + 1).normal(size=M).astype(np.float32)
    j, t = _bf16(x)
    t = _in_buffer(t, view)
    want = np.asarray(_read_call(scripts["panel_floor"]._read_kernel, j,
                                 jnp.asarray(u)[None, :], BM, 128))[0]
    ut = torch.from_numpy(u)
    got = pr.stream_read(t, ut).numpy()
    scale = pr.stream_read_plain(t.abs(), ut.abs()).numpy()
    _close(got, want, scale)
    for plan in _plans(M, W):
        _close(pr.stream_read_in_order(t, ut, plan).numpy(), want, scale)
    # not a matvec: a per-row weighting differs
    matvec = (t.to(torch.float32).t() @ ut).numpy()
    assert np.abs(matvec - got).max() > 1e3 * RTOL * scale.max()


def test_read_plain_formula_ragged():
    """Ragged rows (the last block short) and width: the block formula."""
    M, W = 1100, 130
    x = _panel(M, W, seed=5)
    u = np.random.default_rng(6).normal(size=M).astype(np.float32)
    _, t = _bf16(x)
    xf = t.to(torch.float32).numpy().astype(np.float64)
    want = sum(xf[b:b + BM].sum(0) * u[b] for b in range(0, M, BM))
    got = pr.stream_read(t, torch.from_numpy(u)).numpy()
    scale = sum(np.abs(xf[b:b + BM]).sum(0) * abs(u[b])
                for b in range(0, M, BM))
    _close(got, want, scale)


# -------------------------------------------------------------- P2 read floor

@pytest.mark.parametrize("M,W", [(1024, 256), (1536, 128), (1536, 256)])
def test_read_floor_matches_pallas(scripts, M, W):
    """P2's read floor: NaN-skip column sums, NaNs present, through the
    wrapper and through the kernel's order of additions under each
    plan."""
    x = _panel(M, W, seed=W, nan_frac=0.4)
    j, t = _bf16(x)
    kern = scripts["panel_kernel_variants"]._read_kernel
    want = np.asarray(pl.pallas_call(
        kern, grid=(W // 128, M // BM),
        in_specs=[pl.BlockSpec((BM, 128), lambda jw, im: (im, jw))],
        out_specs=pl.BlockSpec((1, 128), lambda jw, im: (0, jw)),
        out_shape=jax.ShapeDtypeStruct((1, W), jnp.float32),
        interpret=True)(j))[0]
    got = pr.stream_read(t).numpy()
    scale = pr.stream_read(t.abs()).numpy()
    assert np.isfinite(got).all()
    _close(got, want, scale)
    for plan in _plans(M, W):
        _close(pr.stream_read_in_order(t, None, plan).numpy(), want, scale)


def test_read_floor_plain_formula_ragged():
    x = _panel(700, 77, seed=9, nan_frac=0.5)
    _, t = _bf16(x)
    xf = t.to(torch.float32).numpy().astype(np.float64)
    want = np.nansum(xf, axis=0)
    _close(pr.stream_read(t).numpy(), want,
           np.nansum(np.abs(xf), axis=0))


# ------------------------------------------------------- P2 rounding variant

def _exact_inputs(M, W, seed):
    """A NaN-sentinel panel and vectors whose products and differences are
    exact in f32 (few mantissa bits), so the interpret run's FMA
    contraction cannot differ from the port's separate roundings: the sums
    the bf16 store rounds are the same, and ties are frequent."""
    rng = np.random.default_rng(seed)
    R = (rng.integers(-64, 64, (M, W)) / 8.0).astype(np.float32)
    R[rng.random((M, W)) < 0.5] = np.nan
    vecs = [(rng.integers(-32, 32, n) / 16.0).astype(np.float32)
            for n in (M, M, W, W)]
    return R, vecs


@pytest.mark.parametrize("M,W,bm,bw", [(1024, 256, 512, 128),
                                       (512, 512, 256, 256)])
def test_rounding_variant_matches_pallas_astype(scripts, M, W, bm, bw):
    """A1: the stored residual is bit-equal to the JAX _uv_kernel_astype
    run and to K1's plain version; g, h within 1e-5 of Σ|terms|."""
    pkv = scripts["panel_kernel_variants"]
    x, (uo, up, vo, vp) = _exact_inputs(M, W, seed=M + bm)
    j, t = _bf16(x)
    Rj, gj, hj = pkv.run_uv_variant(pkv._uv_kernel_astype, j,
                                    *(jnp.asarray(v) for v in (uo, up, vo,
                                                               vp)),
                                    bm, bw, True)
    tv = [torch.from_numpy(v) for v in (uo, up, vo, vp)]
    t1, tk = t.clone(), t.clone()
    launches.reset_launch_counts()
    g, h = pk.panel_update_vsweep_irne(t1, *tv)
    assert launches.launch_counts()["panel_update_vsweep_irne"] == 0
    pk.panel_update_vsweep(tk, *tv)
    nan = np.isnan(np.array(Rj.astype(jnp.float32)))
    np.testing.assert_array_equal(np.isnan(t1.to(torch.float32).numpy()), nan)
    np.testing.assert_array_equal(_tbits(t1)[~nan], _jbits(Rj)[~nan])
    np.testing.assert_array_equal(_tbits(t1), _tbits(tk))
    assert np.isnan(t1.to(torch.float32).numpy()).sum() == np.isnan(x).sum()
    sg, _ = pk.panel_vsweep_plain(t1.abs(), tv[0].abs())
    _close(g.numpy(), np.asarray(gj)[0], sg.numpy())
    _close(h.numpy(), np.asarray(hj)[0], h.numpy())


def test_rounding_variant_equals_k1_on_random_inputs():
    """On general f32 inputs the integer RNE and the dtype conversion store
    the same bits (K1's plain version against the variant's), NaN kept."""
    rng = np.random.default_rng(3)
    M, W = 300, 170
    x = _panel(M, W, seed=3, nan_frac=0.3)
    _, t = _bf16(x)
    tv = [torch.from_numpy(rng.normal(size=n).astype(np.float32))
          for n in (M, M, W, W)]
    a, b = t.clone(), t.clone()
    ga, ha = pk.panel_update_vsweep_irne(a, *tv)
    gb, hb = pk.panel_update_vsweep(b, *tv)
    np.testing.assert_array_equal(_tbits(a), _tbits(b))
    assert torch.equal(ga, gb) and torch.equal(ha, hb)


def test_round_irne_edges():
    """Ties to even, the largest finite values, infinities, NaN, -0."""
    vals = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8), 3.3895e38,
                     3.40282e38, -3.40282e38, np.inf, -np.inf, np.nan, -0.0,
                     1e-40, -1e-40], np.float32)
    x = torch.from_numpy(vals)
    got = pk.round_irne(x)
    np.testing.assert_array_equal(_tbits(got), _tbits(x.to(torch.bfloat16)))


def test_rounding_variant_takes_bf16_only():
    t = torch.zeros((4, 4))
    v = torch.zeros(4)
    with pytest.raises(TypeError, match="bfloat16"):
        pk.panel_update_vsweep_irne(t, v, v, v, v)


# ------------------------------------------------------------------ P3 gather

def _gather_call(kernel, idx, tab, bm):
    """probe_vmem_gather.run's pallas_call with interpret=True."""
    rows, L = idx.shape
    S = tab.shape[0]
    return pl.pallas_call(
        kernel, grid=(rows // bm,),
        in_specs=[pl.BlockSpec((bm, L), lambda i: (i, 0)),
                  pl.BlockSpec((S, L), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((bm, L), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((rows, L), jnp.float32),
        interpret=True)(idx, tab)


@pytest.mark.parametrize("form,body", [("A", "kernel_take"),
                                       ("B", "kernel_fancy"),
                                       ("C", "kernel_rowloop")])
def test_gather_matches_pallas(scripts, form, body):
    S, rows, L = 64, 256, 128
    rng = np.random.default_rng(11)
    tab = rng.normal(size=(S, L)).astype(np.float32)
    hi = S * L if form == "B" else S
    idx = rng.integers(0, hi, (rows, L)).astype(np.int32)
    want = np.asarray(_gather_call(getattr(scripts["probe_vmem_gather"],
                                           body), jnp.asarray(idx),
                                   jnp.asarray(tab), 128))
    got = pr.gather(torch.from_numpy(tab), torch.from_numpy(idx), form)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("form", ["A", "B", "C"])
def test_gather_plain_formula_ragged_and_out_of_range(form):
    """Ragged (rows, L) and S; an index outside the table reads 0."""
    S, rows, L = 13, 7, 5
    rng = np.random.default_rng(12)
    tab = rng.normal(size=(S, L)).astype(np.float32)
    n = S * L if form == "B" else S
    idx = rng.integers(-3, n + 3, (rows, L)).astype(np.int32)
    got = pr.gather(torch.from_numpy(tab), torch.from_numpy(idx), form)
    want = np.zeros((rows, L), np.float32)
    for r in range(rows):
        for c in range(L):
            i = idx[r, 0] if form == "C" else idx[r, c]
            if 0 <= i < n:
                want[r, c] = (tab.reshape(-1)[i] if form == "B"
                              else tab[i, c])
    np.testing.assert_array_equal(got.numpy(), want)


#: the smoke's new gather checks (table rows, index rows): the bench's rows
#: tail at the headline, the largest table the H100's shared-memory path
#: takes, and one row over it
SMOKE_GATHER_SHAPES = ((417, 37), (453, 37), (454, 37))


@pytest.mark.parametrize("S,rows", SMOKE_GATHER_SHAPES)
@pytest.mark.parametrize("form,body", [("A", "kernel_take"),
                                       ("B", "kernel_fancy"),
                                       ("C", "kernel_rowloop")])
def test_gather_plain_matches_pallas_at_smoke_shapes(scripts, form, body, S,
                                                     rows):
    """gather_plain against the Pallas bodies (interpret mode) at the
    smoke's table shapes, also through an index and an output viewed 4
    bytes into their buffers."""
    L = 128
    rng = np.random.default_rng(S)
    tab = rng.normal(size=(S, L)).astype(np.float32)
    hi = S * L if form == "B" else S
    idx = rng.integers(0, hi, (rows, L)).astype(np.int32)
    want = np.asarray(_gather_call(getattr(scripts["probe_vmem_gather"],
                                           body), jnp.asarray(idx),
                                   jnp.asarray(tab), rows))
    got = pr.gather_plain(torch.from_numpy(tab), torch.from_numpy(idx), form)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    ib = torch.zeros(idx.size + 1, dtype=torch.int32)
    iv = ib[1:].view(rows, L)
    iv.copy_(torch.from_numpy(idx))
    ob = torch.full((idx.size + 2,), float("nan"))
    ov = ob[1:-1].view(rows, L)
    assert pr.gather(torch.from_numpy(tab), iv, form, out=ov) is ov
    np.testing.assert_array_equal(ov.numpy().view(np.int32),
                                  want.view(np.int32))
    assert torch.isnan(ob[0]) and torch.isnan(ob[-1])


@pytest.mark.parametrize("name,S,rows,path,kernels", [
    ("rows tail", 417, 22_659, "smem", {"A": "cols", "B": "table"}),
    ("cols tail", 7503, 23_655, "l2", {"A": "l2", "B": "l2"}),
    ("probe", 8192, 4096, "l2", {"A": "l2", "B": "l2"})])
def test_gather_plan_paths_at_the_bench_shapes(name, S, rows, path, kernels):
    """The rows tail's table (213,504 bytes) fits the H100's opt-in shared
    memory; the cols tail's (3.84 MB) and the probe's (4 MB) do not."""
    from cuda_recommender_tpu_torch.scripts.probe_gather import tail_shape
    if name != "probe":
        lanes, ents, width = ((2_900_227, 17_771, 3) if name == "rows tail"
                              else (3_027_760, 480_190, 2))
        assert tail_shape(lanes, ents, width) == (S, rows)
    n = rows * 128
    for form in ("A", "B"):
        plan = pr.gather_plan(S, 128, n, pr.H100_SMEM_OPTIN, form=form)
        assert plan["path"] == path and plan["kernel"] == kernels[form]
        assert plan["head"] == plan["tail"] == 0 and plan["idx_vec"]
        assert plan["steps"] * plan["per_thread"] == n
        if path == "smem":
            assert plan["grid"] == pr.H100_SMS // 4 * 4 if form == "B" \
                else pr.H100_SMS
            assert plan["smem_bytes"] == (16 + S * 128 if form == "A" else
                                          32 + S * 512)
        else:
            assert plan["grid"] == min(-(-n // 4 // 128),
                                       8 * pr.H100_SMS)
            assert plan["smem_bytes"] == 0
    assert pr.gather_smem_bytes(S, 128) == 32 + S * 512


def test_gather_plan_at_the_limit():
    """A table exactly at the limit takes shared memory; one byte less of
    limit, or one row more of table, takes L2, and asking for shared
    memory then raises. On the H100 the largest 128-lane table is 453
    rows."""
    for S, L in ((453, 128), (97, 3), (1, 1)):
        need = pr.gather_smem_bytes(S, L)
        assert pr.gather_plan(S, L, 64, need)["path"] == "smem"
        assert pr.gather_plan(S, L, 64, need - 1)["path"] == "l2"
        with pytest.raises(ValueError, match="shared memory"):
            pr.gather_plan(S, L, 64, need - 1, path="smem")
        assert pr.gather_plan(S, L, 64, need, path="l2")["path"] == "l2"
    assert pr.gather_plan(453, 128, 64, pr.H100_SMEM_OPTIN)["path"] == "smem"
    assert pr.gather_plan(454, 128, 64, pr.H100_SMEM_OPTIN)["path"] == "l2"
    with pytest.raises(ValueError, match="path must be"):
        pr.gather_plan(4, 4, 16, pr.H100_SMEM_OPTIN, path="vmem")


@pytest.mark.parametrize("n,out_off,idx_off,path,want", [
    # (head, steps, tail, idx_vec)
    (1000, 0, 0, "l2", (0, 250, 0, True)),
    (1001, 0, 0, "l2", (0, 250, 1, True)),
    (1003, 4, 4, "l2", (3, 250, 0, True)),
    (1003, 4, 8, "l2", (3, 250, 0, False)),
    (1007, 8, 8, "smem", (2, 125, 5, True)),
    (1007, 12, 0, "smem", (1, 125, 6, False)),
    (2, 4, 4, "smem", (2, 0, 0, False)),
    (5, 4, 4, "l2", (3, 0, 2, True))])
def test_gather_plan_head_and_tail(n, out_off, idx_off, path, want):
    """Index elements not a multiple of a step, and views at 4-byte
    offsets: up to 3 head elements reach the output's 16-byte boundary,
    the tail is what is left after whole steps, and the index is read 16
    bytes at a time only where it is aligned at the first step."""
    plan = pr.gather_plan(3, 1, n, pr.H100_SMEM_OPTIN, path=path,
                          out_offset=out_off, idx_offset=idx_off)
    got = (plan["head"], plan["steps"], plan["tail"], plan["idx_vec"])
    assert got == want
    assert plan["head"] + plan["steps"] * plan["per_thread"] + \
        plan["tail"] == n
    assert plan["kernel"] == ("table" if path == "smem" else "l2")


def test_gather_plan_column_groups_need_alignment():
    """Form A copies only its 32-lane column group where every operand is
    16-byte aligned and L is a multiple of 32; otherwise the whole table."""
    def kernel(L, **offsets):
        return pr.gather_plan(40, L, 40 * L, pr.H100_SMEM_OPTIN, form="A",
                              **offsets)["kernel"]
    assert kernel(128) == kernel(96) == kernel(32) == "cols"
    assert kernel(40) == kernel(16) == "table"
    for key in ("tab_offset", "idx_offset", "out_offset"):
        assert kernel(128, **{key: 4}) == "table"
    plan = pr.gather_plan(40, 96, 40 * 96, pr.H100_SMEM_OPTIN, form="A")
    assert plan["grid"] == 3 and plan["smem_bytes"] == 16 + 40 * 128
    plan = pr.gather_plan(417, 96, 22_659 * 96, pr.H100_SMEM_OPTIN,
                          form="A")
    assert plan["grid"] == 132     # 3 groups x 44 blocks


def test_gather_wrapper_refuses_shared_memory_over_the_limit():
    """Forcing the shared-memory path for a table over the limit raises
    (a CPU tensor's plan takes the H100's limit), as does a path for form
    C; a valid request on the CPU returns the plain version."""
    tab = torch.zeros((454, 128))
    idx = torch.zeros((3, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        pr.gather(tab, idx, "A", path="smem")
    with pytest.raises(ValueError, match="form C"):
        pr.gather(tab, idx, "C", path="l2")
    got = pr.gather(tab[:453].contiguous(), idx, "B", path="smem")
    assert torch.equal(got, torch.zeros((3, 128)))
    launches.reset_launch_counts()
    pr.gather(tab, idx, "A", path="l2")
    assert set(launches.launch_counts().values()) == {0}   # CPU: plain


# ---------------------------------------------------------- wrappers, build

@pytest.mark.parametrize("bad", ["dtype", "dims", "stride", "u"])
def test_stream_wrappers_validate(bad):
    R = torch.zeros((8, 6), dtype=torch.bfloat16)
    u = torch.zeros(8)
    if bad == "dtype":
        R = R.float()
    elif bad == "dims":
        R = R[0]
    elif bad == "stride":
        R = torch.zeros((6, 8), dtype=torch.bfloat16).t()
    if bad == "u":
        with pytest.raises(ValueError, match="u must be"):
            pr.stream_read(R, torch.zeros(7))
        return
    with pytest.raises((TypeError, ValueError)):
        pr.stream_rmw(R)
    with pytest.raises((TypeError, ValueError)):
        pr.stream_read(R, u)


@pytest.mark.parametrize("bad", ["form", "tab_dtype", "idx_dtype", "lanes",
                                 "out_shape", "out_dtype", "out_stride"])
def test_gather_wrapper_validates(bad):
    tab, idx, form = torch.zeros((4, 3)), torch.zeros((2, 3),
                                                      dtype=torch.int32), "A"
    out = None
    if bad == "form":
        form = "D"
    elif bad == "tab_dtype":
        tab = tab.double()
    elif bad == "idx_dtype":
        idx = idx.long()
    elif bad == "lanes":
        idx = torch.zeros((2, 4), dtype=torch.int32)
    elif bad == "out_shape":
        out = torch.zeros((3, 3))
    elif bad == "out_dtype":
        out = torch.zeros((2, 3), dtype=torch.float64)
    else:
        out = torch.zeros((3, 2)).t()
    with pytest.raises((TypeError, ValueError)):
        pr.gather(tab, idx, form, out=out)


def test_build_binds_the_probe_kernels():
    """The probe library and K1's rounding variant are bound with one
    argtype per C parameter (test_torch_gj.py checks the parse for every
    source)."""
    assert set(build.SIGNATURES["probe_kernels"]) == {
        "crtpu_stream_rmw", "crtpu_stream_read", "crtpu_stream_read_blocks",
        "crtpu_gather", "crtpu_gather_limits"}
    assert len(build.SIGNATURES["probe_kernels"]["crtpu_stream_rmw"]) == 4
    assert len(build.SIGNATURES["probe_kernels"]["crtpu_stream_read"]) == 10
    assert len(build.SIGNATURES["probe_kernels"]
               ["crtpu_stream_read_blocks"]) == 3
    assert len(build.SIGNATURES["probe_kernels"]["crtpu_gather"]) == 9
    assert len(build.SIGNATURES["probe_kernels"]
               ["crtpu_gather_limits"]) == 3
    assert len(build.SIGNATURES["panel_kernels"]
               ["crtpu_update_vsweep_irne"]) == 13
    assert build.library_path("probe_kernels") != build.library_path(
        "panel_kernels")
