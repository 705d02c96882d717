"""The port's fp8 e4m3fn residual against the JAX package.

Rounding: ``ops/densify.py::round_to_storage`` against JAX's ``astype``,
bit for bit, over every fp8 value, every midpoint between neighbours and
one f32 ULP either side of it, the overflow edge (448, 464 and its
neighbours, 480), the subnormals, ±0, ±inf and NaN of both signs
(PyTorch's own cast saturates at 448 instead).

Kernels (their plain versions, the CUDA kernels' oracle on the card):
"once" against the Pallas kernels in interpret mode (K1-K3 NaN panels, K4
with a bf16 mask): stored bits equal, g and h rtol 2e-5, atol 2e-4
(blocked against chunked f32 sums, as tests/test_torch_panel_kernels.py).
One exception: the interpret-mode K1's g at fp8 is not the sweep of the
values it stores, which its own definition asks for (ops/panel_pallas.py:
134-160): on the CPU, XLA folds the kernel's fp8 round trip
``astype(fp8).astype(f32)`` into the dot in some cells (measured: most
columns exact, one off by 7% of its sum(|terms|); K3 and K2 over the same
stored panel within 1e-7). So K1's g is held to f64 sums over the stored
values at that bar, its h to the Pallas kernel's;
"delta_first" against a jitted ``R + (delta·mask).astype(fp8)`` (the XLA
update of the JAX dense step and einsum panels) on the same f32 delta:
stored bits equal, and g, h within the same bars of f64 sums over the
JAX-stored residual.

Steps: each backend from one JAX state (the JAX state after an outer step,
carried across through its fp8 payload) runs one more outer step, the JAX
package the same: dense and the explicit-mask and NaN hybrids without the
panel kernel store delta-first (XLA), pallas and the NaN hybrid with the
panel kernel once (Pallas). The JAX steps of the XLA order run eagerly
(``jax.disable_jit``): jitted on the CPU, XLA fuses the einsum sweep with
the fp8 store before it and sums it to about 2^-8 (the fusion's
artefact), which tips a fifth of the next ranks' fp8 roundings;
eagerly every op is f32. The steps with the Pallas kernels run jitted:
evaluated eagerly, the interpret-mode K1's g departs from the values it
stores (as above), which steers the next ranks and tips some 6% of the
cells, while the jitted step sweeps what it stores (XLA's
``--xla_allow_excess_precision=false`` changes neither: measured). One
bar for every path: at most STEP_CELLS_OFF of the observed residual
cells store another fp8 value (f32 sums a few ULPs apart could tip a
rare rounding; measured: none), the factors, pending vectors and tail
values within STEP_TOL, the f32 steps' bar (tests/test_torch_dense.py).
The other store order misses the cell bar by far (OTHER_ORDER_OFF;
after a whole step most cells, about 92% beside the Pallas K1).

Runs: the fp8 hybrid tracks the golden run within 0.05 for 3 iterations
(the JAX package's own bar, tests/test_hybrid.py:221-237); fp8
checkpoints resume bit-equal, and JAX fp8 payloads load in both
directions.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.ops import ccd_pallas as jk
from cuda_recommender_tpu.ops import panel_pallas as jp
from cuda_recommender_tpu.ops.densify import densify_coo as jax_densify
from cuda_recommender_tpu.solvers import ccd_dense as jd
from cuda_recommender_tpu.solvers import ccd_hybrid as jh
from cuda_recommender_tpu.solvers import ccd_pallas as jpl
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.ops import panel_kernels as pk
from cuda_recommender_tpu_torch.ops.densify import (
    FP8, RESIDUAL_DTYPES, densify_coo_mask, densify_coo_nan,
    round_to_storage, store_order)
from cuda_recommender_tpu_torch.scripts import fp8_grid
from cuda_recommender_tpu_torch.solvers import ccd_dense as td
from cuda_recommender_tpu_torch.solvers import ccd_hybrid as th
from cuda_recommender_tpu_torch.solvers.dense_state import (
    dense_state_from_numpy, dense_state_to_numpy)
from cuda_recommender_tpu_torch.solvers.hybrid_state import (
    hybrid_state_from_numpy, hybrid_state_to_numpy)
from cuda_recommender_tpu_torch.solvers.reference import ccd_reference

JFP8 = jnp.float8_e4m3fn
K = 6
#: one-step bars (module docstring)
STEP_CELLS_OFF = 0.01
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
OTHER_ORDER_OFF = 0.10
#: the hybrid stair of tests/test_torch_hybrid_mask.py: panels and a tail
STAIR = dict(hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16))


def _small():
    """tests/conftest.py's small_data, from the port's own generator."""
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.uint8).numpy()


def _jax_bits(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(JFP8)).view(np.uint8)


# ------------------------------------------------------------------ rounding

def _edge_values() -> np.ndarray:
    """Every fp8 value, each midpoint between neighbours ± 1 f32 ULP, the
    overflow edge, the subnormals, ±0, ±inf, NaN of both signs."""
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = grid.astype(np.float32)
    fin = np.unique(vals[np.isfinite(vals)])
    mids = ((fin[:-1].astype(np.float64) + fin[1:]) / 2).astype(np.float32)
    ulp = np.nextafter(mids, np.float32(np.inf)), np.nextafter(
        mids, np.float32(-np.inf))
    edge = np.array([448, 460, 463.99997, 464, 464.00003, 465, 470, 479,
                     480, 500, 1e6, 2 ** -9, 2 ** -10, 3 * 2 ** -11,
                     2 ** -6, 2 ** -7, 0.0, -0.0, np.inf, -np.inf],
                    np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    out = np.concatenate([vals, mids, *ulp, edge, nans])
    return np.concatenate([out, -out])


def test_round_to_storage_is_jax_astype():
    x = _edge_values()
    got = _bits(round_to_storage(torch.from_numpy(x), FP8))
    np.testing.assert_array_equal(got, _jax_bits(x))
    # PyTorch's own cast saturates where JAX gives NaN
    assert int(torch.tensor([470.0]).to(FP8).view(torch.uint8)) == 0x7E
    assert int(round_to_storage(torch.tensor([470.0]), FP8).view(
        torch.uint8)) == 0x7F


def test_round_to_storage_random_and_wide_dtypes():
    """Random values over fp8's whole range (and past it) round as JAX's
    astype; f32 and bf16 keep PyTorch's conversion."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(200_000) * np.exp2(
        rng.integers(-12, 10, 200_000))).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(round_to_storage(torch.from_numpy(x), FP8)), _jax_bits(x))
    t = torch.from_numpy(x)
    assert torch.equal(round_to_storage(t, torch.bfloat16),
                       t.to(torch.bfloat16))
    assert round_to_storage(t, torch.float32) is t
    assert RESIDUAL_DTYPES["float8_e4m3fn"] == FP8


def test_store_order():
    """Delta-first only at fp8 and only where the JAX path is XLA's."""
    assert store_order(FP8, rounds_once=False) == "delta_first"
    assert store_order(FP8, rounds_once=True) == "once"
    for dt in (torch.float32, torch.bfloat16):
        assert store_order(dt, rounds_once=False) == "once"


# ------------------------------------------------------------------- densify

@pytest.mark.parametrize("mask", ["nan", "bfloat16", "int8"])
def test_densify_matches_jax(mask):
    """Both modes against the JAX package's densify_coo at fp8, ratings
    past the overflow edge included (NaN, as astype gives them)."""
    rng = np.random.default_rng(3)
    rows, width = 37, 29
    cells = rng.choice(rows * width, 300, replace=False)
    lr, lc = (cells // width).astype(np.int32), (cells % width).astype(
        np.int32)
    lv = rng.uniform(-6, 6, 300).astype(np.float32)
    lv[:4] = [450.0, 464.0, 470.0, -1000.0]
    Rj, Mj = jax_densify(jnp.asarray(lr), jnp.asarray(lc), jnp.asarray(lv),
                         rows, width, JFP8, mask)
    if mask == "nan":
        Rt = densify_coo_nan(lr, lc, lv, rows, width, FP8, "cpu")
        assert Mj is None
    else:
        Rt, Mt = densify_coo_mask(lr, lc, lv, rows, width, FP8, mask, "cpu")
        np.testing.assert_array_equal(Mt.to(torch.float32).numpy(),
                                      np.asarray(Mj, np.float32))
    assert Rt.dtype == FP8
    np.testing.assert_array_equal(_bits(Rt), np.asarray(Rj).view(np.uint8))


# ------------------------------------------------------------------- kernels

def _panel(M, W, seed, mask=None):
    """A residual (NaN off a 30% pattern, or 0 beside a {0,1} mask), its
    mask (None for NaN) and four factor vectors; row 0's first cells hold
    1.0 and take a delta of 448, 463, 465 and 800 (the overflow edge)."""
    rng = np.random.default_rng(seed)
    obs = rng.random((M, W)) < 0.3
    obs[0, :4] = True
    R = rng.normal(size=(M, W)).astype(np.float32)
    R[0, :4] = 1.0
    R = np.where(obs, R, np.nan if mask is None else 0.0).astype(np.float32)
    uo, up = (rng.normal(size=M).astype(np.float32) for _ in range(2))
    vo, vp = (rng.normal(size=W).astype(np.float32) for _ in range(2))
    uo[0], up[0] = 32.0, 0.0
    vo[:4] = np.array([448, 463, 465, 800], np.float32) / 32.0
    M_ = None if mask is None else obs.astype(np.float32)
    return R, M_, [uo, up, vo, vp]


def _fp8(x):
    return round_to_storage(torch.from_numpy(np.ascontiguousarray(x)), FP8)


def _jfp8(x):
    return jnp.asarray(x).astype(JFP8)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-5,
                               atol=2e-4)


@pytest.mark.parametrize("M,W,bm,bw", [(48, 256, 16, 128), (40, 128, 8, 128)])
def test_nan_kernels_once_match_pallas(M, W, bm, bw):
    """K1 (once), K3 and K2 against the Pallas kernels at fp8: stored bits
    equal (the planted sums past 464 stored NaN), g and h close."""
    R, _, vecs = _panel(M, W, M * W)
    jv = [jnp.asarray(v) for v in vecs]
    tv = [torch.from_numpy(v) for v in vecs]
    Rn_j, g_j, h_j = jp.panel_update_vsweep(_jfp8(R), *jv, interpret=True,
                                            bm=bm, bw=bw)
    Rt = _fp8(R)
    g_t, h_t = pk.panel_update_vsweep(Rt, *tv)
    np.testing.assert_array_equal(_bits(Rt), np.asarray(Rn_j).view(np.uint8))
    assert (_bits(Rt)[0, :4] & 0x7F).tolist() == [0x7E, 0x7E, 0x7F, 0x7F]
    stored = np.nan_to_num(np.asarray(Rn_j).astype(np.float64))
    u64 = vecs[0].astype(np.float64)
    _close(g_t, stored.T @ u64)
    _close(h_t, h_j)
    g3_j, h3_j = jp.panel_vsweep(Rn_j, jv[1], interpret=True, bm=bm, bw=bw)
    g3_t, h3_t = pk.panel_vsweep(Rt, tv[1])
    _close(g3_t, g3_j)
    _close(h3_t, h3_j)
    g2_j, h2_j = jp.panel_usweep(Rn_j, jv[2], interpret=True, bm=bm, bw=bw)
    g2_t, h2_t = pk.panel_usweep(Rt, tv[2])
    _close(g2_t, g2_j)
    _close(h2_t, h2_j)


def test_k4_once_matches_pallas():
    """K4 (once: the sweep reads the unrounded sum) against the Pallas
    kernel at fp8 with its bf16 mask: stored bits equal, g and h close."""
    M, W = 48, 256
    R, Mk, vecs = _panel(M, W, 11, mask="bfloat16")
    R[0, :4] = 0.0
    R[0, 0] = 1.0
    Rn_j, g_j, h_j = jk.fused_update_vsweep(
        _jfp8(R), jnp.asarray(Mk, jnp.bfloat16),
        *(jnp.asarray(v) for v in vecs), interpret=True, bm=8, bn=128,
        alias=False)
    Rt = _fp8(R)
    g_t, h_t = ck.fused_update_vsweep(
        Rt, torch.from_numpy(Mk).to(torch.bfloat16),
        *(torch.from_numpy(v) for v in vecs))
    np.testing.assert_array_equal(_bits(Rt), np.asarray(Rn_j).view(np.uint8))
    assert (_bits(Rt)[0, 2:4] & 0x7F).tolist() == [0x7F, 0x7F]
    _close(g_t, g_j)
    _close(h_t, h_j)


@jax.jit
def _xla_update(R, delta, mask):
    return R + (delta * mask).astype(JFP8)


@jax.jit
def _xla_update_nan(R, delta):
    return R + delta.astype(JFP8)


@pytest.mark.parametrize("mask", [None, "bfloat16", "int8"])
def test_delta_first_matches_xla(mask):
    """K1 and K4 delta-first against XLA's ``R + (delta·mask).astype``
    on the same f32 delta, bit for bit; their sums read the stored
    values."""
    M, W = 64, 96
    R, Mk, vecs = _panel(M, W, 5, mask)
    uo, up, vo, vp = vecs
    delta = (np.outer(uo, vo) - np.outer(up, vp)).astype(np.float32)
    Rt = _fp8(R)
    tv = [torch.from_numpy(v) for v in vecs]
    if mask is None:
        want = _xla_update_nan(_jfp8(R), jnp.asarray(delta))
        g, h = pk.panel_update_vsweep(Rt, *tv, order="delta_first")
        Mf = None
    else:
        Mt = torch.from_numpy(Mk).to(getattr(torch, mask))
        want = _xla_update(_jfp8(R), jnp.asarray(delta), jnp.asarray(Mk))
        g, h = ck.fused_update_vsweep(Rt, Mt, *tv, order="delta_first")
        Mf = Mk.astype(np.float64)
    np.testing.assert_array_equal(_bits(Rt), np.asarray(want).view(np.uint8))
    assert (_bits(Rt)[0, :4] & 0x7F).tolist() == [0x7E, 0x7E, 0x7F, 0x7F]
    stored = np.asarray(want).astype(np.float64)
    if Mf is None:
        Mf = (~np.isnan(stored)).astype(np.float64)
        stored = np.nan_to_num(stored)
        _close(g, stored.T @ uo)
    else:
        # an explicit-mask sweep sums every cell: the planted NaNs too
        _close(g[4:], (stored.T @ uo)[4:])
    _close(h, Mf.T @ (uo.astype(np.float64) ** 2))


def test_other_order_misses_xla():
    """The single rounding (the Pallas order) against XLA's delta-first
    on one update: about a quarter of the observed cells differ (why each
    backend takes its JAX path's order)."""
    R, Mk, vecs = _panel(256, 512, 9, "bfloat16")
    uo, up, vo, vp = vecs
    delta = (np.outer(uo, vo) - np.outer(up, vp)).astype(np.float32)
    want = np.asarray(_xla_update(_jfp8(R), jnp.asarray(delta),
                                  jnp.asarray(Mk))).view(np.uint8)
    Rt = _fp8(R)
    ck.fused_update_vsweep(Rt, torch.from_numpy(Mk).to(torch.bfloat16),
                           *(torch.from_numpy(v) for v in vecs))
    off = (_bits(Rt) != want)[Mk > 0].mean()
    assert off > OTHER_ORDER_OFF


@pytest.mark.parametrize("order", ["once", "delta_first"])
def test_plain_versions_chunk_invariant(monkeypatch, order):
    """The plain versions' row chunks change no bit at fp8."""
    R, Mk, vecs = _panel(50, 70, 2, "int8")
    tv = [torch.from_numpy(v) for v in vecs]
    Mt = torch.from_numpy(Mk).to(torch.int8)
    outs = []
    for chunk in (1 << 26, 70 * 3):
        monkeypatch.setattr(pk, "_PLAIN_CHUNK_CELLS", chunk)
        Rt = _fp8(R)
        g, h = ck.fused_update_vsweep_plain(Rt, Mt, *tv, order=order)
        outs.append((_bits(Rt).copy(), g, h))
    assert np.array_equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=1e-5, atol=1e-5,
                               equal_nan=True)


def test_wrappers_take_fp8_and_orders():
    """The wrappers take fp8 panels and name the store order; delta-first
    is an fp8 order; the fp8 instances count under their own names."""
    R = _fp8(np.zeros((6, 5), np.float32))
    u, v = torch.zeros(6), torch.zeros(5)
    pk.panel_update_vsweep(R, u, u, v, v, order="delta_first")
    with pytest.raises(ValueError, match="order"):
        pk.panel_update_vsweep(R, u, u, v, v, order="twice")
    with pytest.raises(ValueError, match="fp8 order"):
        pk.panel_update_vsweep(torch.zeros((6, 5)), u, u, v, v,
                               order="delta_first")
    assert pk.instance_name("panel_update_vsweep", FP8) == \
        "panel_update_vsweep_fp8"
    assert pk.instance_name("fused_update_vsweep", FP8, "delta_first") == \
        "fused_update_vsweep_fp8_delta_first"
    assert pk.instance_name("panel_usweep", torch.bfloat16) == "panel_usweep"
    names = launches.launch_counts()
    for base in ("panel_update_vsweep", "fused_update_vsweep"):
        for order in ("once", "delta_first"):
            assert pk.instance_name(base, FP8, order) in names
    for base in ("panel_vsweep", "panel_usweep", "masked_vsweep",
                 "masked_usweep"):
        assert pk.instance_name(base, FP8) in names


@pytest.mark.parametrize("M,W", [(1, 1), (19, 7), (330_128, 17_770),
                                 (40_000_000, 3)])
def test_sweep_geometry_fp8(M, W):
    """At 1 byte a cell the column sweep interleaves 128 rows to a band
    (64 rows of an odd width start 64 bytes apart, not 128) and shifts a
    strip by up to 127 cells; its grid stays within grid.y's limit."""
    rpp, nparts, nstrips = pk._sweep_geometry(M, W, 1)
    assert (nstrips - 1) * 256 < W + 127 <= nstrips * 256
    assert rpp % 8 == 0 and rpp >= 512 and nparts <= 65_535
    assert nparts % 128 == 0
    bands = nparts // 128
    assert (bands - 1) * 128 * rpp < M <= bands * 128 * rpp


# --------------------------------------------------------- the boundary grid

def _grid(mask):
    """Phase 42's boundary grid at its deltas' width (scripts/fp8_grid.py):
    R's bytes, the mask (float32, None for the NaN sentinel), the vectors,
    the delta·mask each cell takes (float32), the panel for the port and
    for JAX, and the port's mask."""
    W = fp8_grid.deltas().size
    Rb, M, vecs = fp8_grid.grid_np(W, mask is not None)
    dm = np.broadcast_to(vecs[2][None, :], Rb.shape).astype(np.float32)
    if M is not None:
        with np.errstate(invalid="ignore"):
            dm = dm * M                  # ±inf and NaN under a 0: NaN
    Rj = jnp.asarray(Rb.view(ml_dtypes.float8_e4m3fn))
    Mt = None if M is None else torch.from_numpy(M).to(getattr(torch, mask))
    return Rb, M, vecs, dm, Rj, Mt


def _grid_plain(Rb, Mt, vecs, order) -> np.ndarray:
    """The bytes the plain version stores on the grid in ``order``."""
    Rt = torch.from_numpy(Rb.copy()).view(FP8)
    tv = [torch.from_numpy(v) for v in vecs]
    if Mt is None:
        pk.panel_update_vsweep_plain(Rt, *tv, order=order)
    else:
        ck.fused_update_vsweep_plain(Rt, Mt, *tv, order=order)
    return _bits(Rt)


def test_grid_covers_every_boundary():
    """The grid's deltas hold every fp8 value, every midpoint and one ULP
    either side, the overflow edge, ±0, ±inf and NaN of both signs; each
    column meets all 256 bytes, and with a mask every byte meets every
    delta under a 0 and under a 1; neighbours in a row hold neighbouring
    bytes (NaN beside a finite cell in one pair)."""
    d = fp8_grid.deltas()
    assert d.size % 128 == 0
    bits = set(d.view(np.uint32).tolist())
    vals = fp8_grid.fp8_values()
    np.testing.assert_array_equal(vals.astype(ml_dtypes.float8_e4m3fn)
                                  .view(np.uint8)[np.isfinite(vals)],
                                  np.arange(256)[np.isfinite(vals)])
    fin = np.unique(vals[np.isfinite(vals)])
    mids = ((fin[:-1].astype(np.float64) + fin[1:]) / 2).astype(np.float32)
    for arr in (fin, mids, np.nextafter(mids, np.float32(np.inf)),
                np.nextafter(mids, np.float32(-np.inf))):
        assert set(arr.view(np.uint32).tolist()) <= bits
    assert np.isnan(d).sum() >= 4 and np.signbit(d[np.isnan(d)]).any()
    Rb, M, vecs = fp8_grid.grid_np(d.size, mask=True)
    assert all(len(set(Rb[:, c])) == 256 for c in (0, 1, 777))
    for c in (0, 5, 1000):
        for m in (0.0, 1.0):
            assert len(set(Rb[M[:, c] == m, c])) == 256
    row = Rb[3].astype(int)
    assert np.all(np.diff(row) % 256 == 1)
    np.testing.assert_array_equal(vecs[0], 1)
    np.testing.assert_array_equal(vecs[1], 0)
    np.testing.assert_array_equal(vecs[3], 0)


@pytest.mark.parametrize("mask", [None, "bfloat16", "int8"])
def test_grid_delta_first_matches_xla(mask):
    """The plain delta-first store (the card's oracle in phase 42) on the
    boundary grid against XLA's ``R + (delta·mask).astype(fp8)``, jitted
    and eagerly (the ways the XLA-order steps run): every byte equal."""
    Rb, M, vecs, _, Rj, Mt = _grid(mask)
    got = _grid_plain(Rb, Mt, vecs, "delta_first")
    delta = jnp.asarray(np.broadcast_to(vecs[2][None, :], Rb.shape))
    Mj = None if mask is None else jnp.asarray(M, getattr(jnp, mask))
    want = (_xla_update_nan(Rj, delta) if Mj is None
            else _xla_update(Rj, delta, Mj))
    np.testing.assert_array_equal(got, np.asarray(want).view(np.uint8))
    with jax.disable_jit():
        eager = (Rj + delta.astype(JFP8) if Mj is None
                 else Rj + (delta * Mj).astype(JFP8))
    np.testing.assert_array_equal(got, np.asarray(eager).view(np.uint8))


@pytest.mark.parametrize("mask", [None, "bfloat16", "int8"])
def test_grid_once_matches_pallas(mask):
    """The plain once store on the boundary grid against the Pallas
    kernels in interpret mode (K1 on the NaN panel, K4 beside the mask):
    every byte equal, but where R and delta·mask are both NaN: both store
    NaN there, and IEEE leaves the sign of NaN + NaN open (the CPU keeps
    the first operand's: the plain version adds R second, the Pallas
    kernels first; the card makes every arithmetic NaN positive)."""
    Rb, M, vecs, dm, Rj, _ = _grid(mask)
    Mt = None if mask is None else torch.from_numpy(M).to(getattr(torch,
                                                                  mask))
    got = _grid_plain(Rb, Mt, vecs, "once")
    jv = [jnp.asarray(v) for v in vecs]
    if mask is None:
        want = jp.panel_update_vsweep(Rj, *jv, interpret=True, bm=256,
                                      bw=128)[0]
    else:
        want = jk.fused_update_vsweep(
            Rj, jnp.asarray(M, getattr(jnp, mask)), *jv, interpret=True,
            bm=256, bn=128, alias=False)[0]
    want = np.asarray(want).view(np.uint8)
    nan_r = (Rb & 0x7F) == 0x7F
    both = nan_r & np.isnan(dm)
    np.testing.assert_array_equal(got[~both], want[~both])
    assert np.all((got[both] & 0x7F) == 0x7F)
    assert np.all((want[both] & 0x7F) == 0x7F)
    assert (got != want).sum() < both.sum()


# --------------------------------------------------------------------- steps

def _pad(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


@functools.lru_cache(maxsize=None)
def _jax_dense(backend, inner, nsteps=2):
    """``nsteps`` JAX outer steps of the dense (XLA) or pallas (Pallas in
    interpret mode, block-padded) backend at fp8, run eagerly; the payload
    after each (the residual as its fp8 array)."""
    R, _ = _small()
    m, n = R.rows, R.cols
    if backend == "pallas":
        mp, np_ = -(-m // jk.BM) * jk.BM, -(-n // jk.BN) * jk.BN
        step = jpl.make_pallas_outer_step(0.1, inner, interpret=True)
    else:
        mp, np_ = m, n
        step = jd.make_outer_step(0.1, inner, residual_dtype=JFP8)
    Rd, mask = jd._device_densify(R, mp, np_, JFP8, mdt="bfloat16")
    W0, _ = init_factors_np(K, m, n, seed=0)
    s = jd.DenseState(Rhat=Rd, W=jnp.asarray(_pad(W0, (K, mp))),
                      H=jnp.zeros((K, np_)), u_pend=jnp.zeros(mp),
                      v_pend=jnp.zeros(np_))
    row_nnz = jnp.asarray(_pad(np.diff(R.csr_ptr).astype(np.float32), (mp,)))
    col_nnz = jnp.asarray(_pad(np.diff(R.csc_ptr).astype(np.float32),
                               (np_,)))
    out = []
    for _ in range(nsteps):
        with jax.disable_jit():
            s = step(s, mask, row_nnz, col_nnz)
        out.append({key: np.array(getattr(s, key)) for key in
                    ("Rhat", "W", "H", "u_pend", "v_pend")})
    return tuple(out)


def _cells_off(got, want, observed) -> float:
    """The share of observed cells whose stored fp8 values differ (NaN
    against NaN equal)."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    return float((~same)[observed].mean())


def _assert_step(got, want, key_r, observed, other=None,
                 cells_off=STEP_CELLS_OFF, tol=STEP_TOL):
    """The module docstring's step bars; ``other`` (the other order's
    residual) misses the cell bar."""
    off = _cells_off(got[key_r], want[key_r], observed)
    assert off <= cells_off, off
    for key in ("W", "H", "u_pend", "v_pend"):
        np.testing.assert_allclose(got[key], np.asarray(want[key],
                                                        np.float32),
                                   err_msg=key, **tol)
    if other is not None:
        assert _cells_off(other, want[key_r], observed) > OTHER_ORDER_OFF


@pytest.mark.parametrize("backend,inner", [("dense", 1), ("dense", 2),
                                           ("pallas", 1)])
def test_dense_step_matches_jax(backend, inner):
    """Dense (delta-first) and pallas (once) from one JAX fp8 state, the
    JAX payload loaded from its fp8 arrays."""
    R, _ = _small()
    p1, p2 = _jax_dense(backend, inner)
    assert p1["Rhat"].dtype == ml_dtypes.float8_e4m3fn
    _, mask = td.device_densify(R, FP8, "bfloat16", "cpu")
    rnz = torch.from_numpy(np.diff(R.csr_ptr).astype(np.float32))
    cnz = torch.from_numpy(np.diff(R.csc_ptr).astype(np.float32))
    order = "once" if backend == "pallas" else "delta_first"
    got = {}
    for o in ("once", "delta_first"):
        st = dense_state_from_numpy(p1, (R.rows, R.cols), FP8, "cpu")
        td.make_outer_step(0.1, inner, order=o)(st, mask, rnz, cnz)
        got[o] = dense_state_to_numpy(st, shape=p2["Rhat"].shape)
    other = "delta_first" if order == "once" else "once"
    observed = np.zeros(p2["Rhat"].shape, bool)
    r, c, _ = R.to_coo()
    observed[r, c] = True
    _assert_step(got[order], p2, "Rhat", observed, got[other]["Rhat"])


@functools.lru_cache(maxsize=None)
def _jax_hybrid(mask, kernel, nsteps=2):
    """``nsteps`` JAX hybrid steps at fp8 (the stair and tail of STAIR):
    the einsum panel path (``kernel`` False, run eagerly) or the Pallas
    panel kernels in interpret mode on block-padded NaN panels (jitted: the
    module docstring); (plan, payloads)."""
    R, _ = _small()
    cfg = JConfig(k=K, lambda_=0.1, backend="hybrid", mask_dtype=mask,
                  hybrid_panel_kernel=kernel, **STAIR)
    plan = jh.plan_hybrid(R, cfg, materialize_dense=False)
    Rds, masks = jh.densify_panels(plan, JFP8, mask_dtype=mask,
                                   block_pad=kernel)
    rows, cols = plan.ell.rows_side, plan.ell.cols_side
    W0, _ = init_factors_np(K, R.rows, R.cols, seed=0)
    s = (Rds, tuple(jnp.asarray(b.val) for b in rows.buckets),
         tuple(jnp.asarray(b.val) for b in cols.buckets),
         jnp.asarray(W0[:, plan.user_order]), jnp.zeros((K, R.cols)),
         jnp.zeros(R.rows), jnp.zeros(R.cols))
    consts = tuple(jnp.asarray(x) for x in (
        plan.row_nnz, plan.col_nnz, plan.upos_of_slot_safe,
        plan.ipos_of_slot_safe, plan.slot_of_upos, plan.slot_of_ipos))
    idx_r = tuple(jnp.asarray(b.idx) for b in rows.buckets)
    idx_c = tuple(jnp.asarray(b.idx) for b in cols.buckets)
    step = jh.make_hybrid_outer_step(plan, 0.1, 1, residual_dtype=JFP8,
                                     nan_mask=mask == "nan",
                                     panel_kernel=kernel)
    eager = contextlib.nullcontext if kernel else jax.disable_jit
    out = []
    for _ in range(nsteps):
        with eager():
            s = step(idx_r, idx_c, s[0], masks, s[1], s[2], s[3], s[4], s[5],
                     s[6], *consts)
        Rds_, vals_r, vals_c, W, H, up, vp = s
        p = {"W": np.array(W), "H": np.array(H), "u_pend": np.array(up),
             "v_pend": np.array(vp)}
        p.update({f"Rd_{i}": np.array(x) for i, x in enumerate(Rds_)})
        p.update({f"vals_r_{i}": np.array(x) for i, x in enumerate(vals_r)})
        p.update({f"vals_c_{i}": np.array(x) for i, x in enumerate(vals_c)})
        out.append(p)
    return plan, tuple(out)


@pytest.mark.parametrize("mask,kernel", [("bfloat16", False),
                                         ("int8", False), ("nan", False),
                                         ("nan", True)])
def test_hybrid_step_matches_jax(mask, kernel):
    """The explicit-mask hybrid and NaN panels without the panel kernel
    (delta-first, the JAX einsum path) and NaN panels with it (once, the
    JAX Pallas kernels) from one JAX fp8 state; the tail's values within
    STEP_TOL too."""
    R, _ = _small()
    plan_j, (p1, p2) = _jax_hybrid(mask, kernel)
    cfg = Config(k=K, lambda_=0.1, backend="hybrid", mask_dtype=mask,
                 hybrid_panel_kernel=kernel, **STAIR)
    plan = th.plan_hybrid(R, cfg, materialize_dense=False)
    assert plan.panels == plan_j.panels
    order = store_order(FP8, kernel)
    shapes = [p2[f"Rd_{i}"].shape for i in range(len(plan.panels))]
    got = {}
    for o in ("once", "delta_first"):
        st = hybrid_state_from_numpy(p1, plan, "cpu", mask, dtype=FP8)
        th.make_hybrid_outer_step(plan, th.device_plan(plan, "cpu"), 0.1, 1,
                                  order=o)(st)
        got[o] = hybrid_state_to_numpy(st, panel_shapes=shapes)
    other = "delta_first" if order == "once" else "once"
    for i, (r0, r1, w) in enumerate(plan.panels):
        want = np.asarray(p2[f"Rd_{i}"], np.float32)
        # the observed cells: those of the panel's COO
        observed = np.zeros(want.shape, bool)
        lr, lc, _ = plan.panel_coo[i]
        observed[lr, lc] = True
        _assert_step(got[order], p2, f"Rd_{i}", observed,
                     got[other][f"Rd_{i}"])
    for key in p2:
        if key.startswith("vals_"):
            np.testing.assert_allclose(got[order][key], p2[key],
                                       err_msg=key, **STEP_TOL)


# ---------------------------------------------------------------------- runs

@pytest.fixture(scope="module")
def golden():
    R, T = _small()
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    W, H = W0.copy(), H0.copy()
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=3)
    return W0, H0, stats


@pytest.mark.parametrize("kw", [
    dict(backend="dense"), dict(backend="pallas"),
    dict(backend="hybrid", mask_dtype="int8", **STAIR),
    dict(backend="hybrid", mask_dtype="nan", **STAIR),
    dict(backend="hybrid", mask_dtype="nan", hybrid_panel_kernel=True,
         **STAIR)], ids=["dense", "pallas", "hybrid_int8", "hybrid_nan",
                         "hybrid_nan_kernel"])
def test_fp8_tracks_golden(golden, kw):
    """Every fp8 path tracks the golden run within 0.05 for 3 iterations
    (tests/test_hybrid.py:221-237's bar); on the CPU no kernel launches."""
    R, T = _small()
    W0, H0, stats_r = golden
    launches.reset_launch_counts()
    res = train(Config(k=K, maxiter=3, lambda_=0.1,
                       residual_dtype="float8_e4m3fn", **kw), R, T,
                device="cpu")
    assert len(res.stats) == 3
    for a, b in zip(res.stats, stats_r):
        assert abs(a.rmse - b.rmse) < 0.05
    assert set(launches.launch_counts().values()) == {0}


@pytest.mark.parametrize("kw", [
    dict(backend="dense"), dict(backend="pallas"),
    dict(backend="hybrid", mask_dtype="int8", **STAIR),
    dict(backend="hybrid", mask_dtype="nan", hybrid_panel_kernel=True,
         **STAIR)], ids=["dense", "pallas", "hybrid_int8",
                         "hybrid_nan_kernel"])
def test_fp8_checkpoint_resume_bit_equal(tmp_path, kw):
    """2 iterations, a checkpoint, a resume to 4: W and H bit-equal to 4
    straight (the residual travels widened to f32 and rounds back
    exactly)."""
    R, T = _small()
    base = dict(k=K, lambda_=0.1, residual_dtype="float8_e4m3fn", **kw)
    full = train(Config(maxiter=4, **base), R, T, device="cpu")
    ck_dir = str(tmp_path / "ck")
    train(Config(maxiter=2, checkpoint_dir=ck_dir, checkpoint_every=1,
                 **base), R, T, device="cpu")
    res = train(Config(maxiter=4, checkpoint_dir=ck_dir, **base), R, T,
                device="cpu", resume_from_checkpoint=True)
    assert [s.oiter for s in res.stats] == [3, 4]
    for name in "WH":
        assert np.array_equal(getattr(full, name).view(np.int32),
                              getattr(res, name).view(np.int32)), name


def test_jax_fp8_payloads_both_ways():
    """A JAX fp8 hybrid state (its fp8 arrays, or widened to f32 as its
    checkpoint stores them) loads into the port bit for bit, and the
    port's payload loads back into the JAX package's dtype exactly."""
    R, _ = _small()
    plan_j, (p1, _) = _jax_hybrid("int8", False)
    plan = th.plan_hybrid(R, Config(k=K, backend="hybrid", mask_dtype="int8",
                                    **STAIR), materialize_dense=False)
    widened = {key: np.asarray(x, np.float32) for key, x in p1.items()}
    a = hybrid_state_from_numpy(p1, plan, "cpu", "int8", dtype=FP8)
    b = hybrid_state_from_numpy(widened, plan, "cpu", "int8", dtype=FP8)
    for i in range(len(plan.panels)):
        want = np.asarray(p1[f"Rd_{i}"]).view(np.uint8)
        np.testing.assert_array_equal(_bits(a.Rds[i]), want)
        np.testing.assert_array_equal(_bits(b.Rds[i]), want)
    back = hybrid_state_to_numpy(a)
    for i in range(len(plan.panels)):
        np.testing.assert_array_equal(
            np.asarray(back[f"Rd_{i}"]).astype(ml_dtypes.float8_e4m3fn)
            .view(np.uint8), np.asarray(p1[f"Rd_{i}"]).view(np.uint8))
    # the dense payload likewise
    d1, _ = _jax_dense("dense", 1)
    st = dense_state_from_numpy({k: np.asarray(v, np.float32)
                                 for k, v in d1.items()},
                                (R.rows, R.cols), FP8, "cpu")
    np.testing.assert_array_equal(_bits(st.Rhat),
                                  np.asarray(d1["Rhat"]).view(np.uint8))
    np.testing.assert_array_equal(
        dense_state_to_numpy(st)["Rhat"].astype(ml_dtypes.float8_e4m3fn)
        .view(np.uint8), np.asarray(d1["Rhat"]).view(np.uint8))


def test_phase_timing_fp8_update_is_delta_first():
    """Phase mode's plain update (``rank1_update``) at fp8 is the JAX
    ``_outer_pass``: R + (sign·outer(u, v)·mask).astype(fp8), bit for
    bit; with no mask a NaN panel absorbs the delta."""
    R, Mk, (u, _, v, _) = _panel(40, 30, 4, "bfloat16")
    delta = -np.outer(u, v).astype(np.float32)
    want = np.asarray(_xla_update(_jfp8(R), jnp.asarray(delta),
                                  jnp.asarray(Mk))).view(np.uint8)
    Rt = _fp8(R)
    td.rank1_update(Rt, torch.from_numpy(Mk).to(torch.bfloat16),
                    torch.from_numpy(u), torch.from_numpy(v), -1.0)
    np.testing.assert_array_equal(_bits(Rt), want)
    Rn, _, _ = _panel(40, 30, 4)
    want = np.asarray(_xla_update_nan(_jfp8(Rn), jnp.asarray(delta))).view(
        np.uint8)
    Rt = _fp8(Rn)
    td.rank1_update(Rt, None, torch.from_numpy(u), torch.from_numpy(v), -1.0)
    np.testing.assert_array_equal(_bits(Rt), want)


@pytest.mark.parametrize("kw", [
    dict(backend="dense"),
    dict(backend="hybrid", mask_dtype="int8", **STAIR),
    dict(backend="hybrid", mask_dtype="nan", **STAIR),
    dict(backend="hybrid", mask_dtype="nan", hybrid_panel_kernel=True,
         **STAIR)], ids=["dense", "hybrid_int8", "hybrid_nan",
                         "hybrid_nan_kernel"])
def test_fp8_sharded_over_one_rank_is_single_device(kw):
    """The sharded trainers at fp8, over a world of one rank in this
    process (gloo): the same store order and kernels as one device, so W
    and H bit-equal."""
    from cuda_recommender_tpu_torch.parallel import multihost
    from cuda_recommender_tpu_torch.parallel.mesh import make_mesh

    R, T = _small()
    cfg = Config(k=K, maxiter=2, lambda_=0.1, residual_dtype="float8_e4m3fn",
                 **kw)
    multihost.initialize_local("cpu")
    try:
        got = train(cfg, R, T, device="cpu", mesh=make_mesh(1))
    finally:
        multihost.shutdown()
    want = train(cfg, R, T, device="cpu")
    for name in "WH":
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
