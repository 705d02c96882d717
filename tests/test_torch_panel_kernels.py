"""Port panel kernels (K1-K3) against the JAX package's Pallas kernels.

The same NumPy-seeded inputs go through ``cuda_recommender_tpu/ops/
panel_pallas.py`` (Pallas in interpret mode on the CPU, as
tests/test_pallas.py runs it) and ``cuda_recommender_tpu_torch/ops/
panel_kernels.py``. On CPU tensors the port's wrappers take their plain
PyTorch versions, which are the CUDA kernels' oracle on the card
(chip_smoke.py phase 3), so this holds the kernels' definition to the JAX
one. Tolerances: f32 residual rtol 2e-6, atol 2e-6 (tests/test_pallas.py:115;
XLA contracts the delta into an FMA, the port rounds each product); bf16
residual equal up to one bf16 ULP where those two f32 sums round apart;
g and h rtol 2e-5, atol 2e-4 (tests/test_pallas.py:122-137: blocked vs
chunked f32 accumulation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.ops import panel_pallas as jp
from cuda_recommender_tpu_torch.ops import build, launches
from cuda_recommender_tpu_torch.ops import panel_kernels as pk

#: (M, W, bm, bw): the last is wider than a row-sweep segment (the card's
#: K2 cuts its rows into 4 segments at f32 and bf16), and its Pallas
#: kernels accumulate across 8 column blocks
SHAPES = [(48, 64, 16, 32), (50, 70, 16, 32), (16, 128, 16, 128),
          (8, 30_001, 8, 4096)]
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


def _inputs(M, W, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((M, W)) < 0.3
    Rd = np.where(mask, rng.normal(size=(M, W)).astype(np.float32), np.nan)
    vecs = [rng.normal(size=s).astype(np.float32) for s in (M, M, W, W)]
    return Rd.astype(np.float32), vecs


def _port_panel(Rd_np, tdt):
    return torch.from_numpy(Rd_np.copy()).to(tdt)


def _jax_to_np32(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))      # writable copy


def _assert_residual(port, ref, name):
    """Port residual (torch) vs JAX residual (f32 numpy of the stored
    dtype's values): NaN positions identical; f32 within rtol/atol 2e-6;
    bf16 within one ULP."""
    got = port.to(torch.float32).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(ref))
    obs = ~np.isnan(ref)
    if name == "float32":
        np.testing.assert_allclose(got[obs], ref[obs], rtol=2e-6, atol=2e-6)
    else:
        gb = port.view(torch.int16).numpy().astype(np.int32)[obs]
        rb = (torch.from_numpy(ref).to(torch.bfloat16).view(torch.int16)
              .numpy().astype(np.int32)[obs])
        assert np.abs(gb - rb).max(initial=0) <= 1


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("M,W,bm,bw", SHAPES)
def test_panel_kernels_match_pallas(M, W, bm, bw, name, jdt, tdt):
    Rd, (uo, up, vo, vp) = _inputs(M, W, seed=M * W)
    if W > 8192:
        assert pk.row_sweep_plan(M, W, tdt.itemsize)["segments"] > 1
    launches.reset_launch_counts()
    j = {x: jnp.asarray(v) for x, v in zip(("uo", "up", "vo", "vp"),
                                            (uo, up, vo, vp))}
    t = {x: torch.from_numpy(v) for x, v in zip(("uo", "up", "vo", "vp"),
                                                (uo, up, vo, vp))}

    # K1: update + v-sweep
    Rn_j, g_j, h_j = jp.panel_update_vsweep(
        jnp.asarray(Rd, jdt), j["uo"], j["up"], j["vo"], j["vp"],
        interpret=True, bm=bm, bw=bw)
    Rt = _port_panel(Rd, tdt)
    g_t, h_t = pk.panel_update_vsweep(Rt, t["uo"], t["up"], t["vo"],
                                      t["vp"])
    _assert_residual(Rt, _jax_to_np32(Rn_j), name)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=2e-5,
                               atol=2e-4)

    # K3 and K2 on one shared input: the JAX kernel's updated panel
    R_shared = _jax_to_np32(Rn_j)
    Rs = _port_panel(R_shared, tdt)
    g3_j, h3_j = jp.panel_vsweep(jnp.asarray(R_shared, jdt), j["up"],
                                 interpret=True, bm=bm, bw=bw)
    g3_t, h3_t = pk.panel_vsweep(Rs, t["up"])
    np.testing.assert_allclose(g3_t.numpy(), np.asarray(g3_j), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(h3_t.numpy(), np.asarray(h3_j), rtol=2e-5,
                               atol=2e-4)
    g2_j, h2_j = jp.panel_usweep(jnp.asarray(R_shared, jdt), j["vo"],
                                 interpret=True, bm=bm, bw=bw)
    g2_t, h2_t = pk.panel_usweep(Rs, t["vo"])
    np.testing.assert_allclose(g2_t.numpy(), np.asarray(g2_j), rtol=2e-5,
                               atol=2e-4)
    np.testing.assert_allclose(h2_t.numpy(), np.asarray(h2_j), rtol=2e-5,
                               atol=2e-4)
    # the read-only sweeps leave the panel alone
    assert torch.equal(Rs.view(torch.int16 if name == "bfloat16"
                               else torch.int32),
                       _port_panel(R_shared, tdt).view(
                           torch.int16 if name == "bfloat16"
                           else torch.int32))
    # CPU tensors take the plain versions: no kernel launched
    assert set(launches.launch_counts().values()) == {0}


#: widths of every residue mod 8 and mod 16 (the card's kernels move 8
#: cells a lane in 16-byte vectors, so rows start off a 16-byte boundary in
#: as many ways), W < 8 and W = 1 among them
ALIGN_WIDTHS = list(range(1, 18))


def _jax_padded(R, vecs, jdt, bm=8, bw=128):
    """NaN-padded panel and zero-padded vectors at the Pallas blocks, so
    that every width shares one compiled kernel; the pad cells are
    unobserved and add nothing to g and h."""
    M, W = R.shape
    Mp, Wp = -(-M // bm) * bm, -(-W // bw) * bw
    Rp = np.full((Mp, Wp), np.nan, np.float32)
    Rp[:M, :W] = R
    pads = (Mp, Mp, Wp, Wp)
    return (jnp.asarray(Rp, jdt),
            [jnp.asarray(np.pad(v, (0, p - v.shape[0]))) for v, p in
             zip(vecs, pads)])


@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("W", ALIGN_WIDTHS)
def test_plain_matches_pallas_every_alignment(W, name, jdt, tdt):
    """K1's and K3's plain versions (the card's oracles) against the Pallas
    kernels at every row alignment the card's kernels branch on, 19 rows
    (not a multiple of the Pallas block)."""
    M = 19
    Rd, vecs = _inputs(M, W, seed=W)
    Rj, (uo, up, vo, vp) = _jax_padded(Rd, vecs, jdt)
    Rn_j, g_j, h_j = jp.panel_update_vsweep(Rj, uo, up, vo, vp,
                                            interpret=True, bm=8, bw=128)
    t = [torch.from_numpy(v) for v in vecs]
    Rt = _port_panel(Rd, tdt)
    g_t, h_t = pk.panel_update_vsweep(Rt, *t)
    R_new = _jax_to_np32(Rn_j)
    _assert_residual(Rt, R_new[:M, :W], name)
    for got, want in ((g_t, g_j), (h_t, h_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:W],
                                   rtol=2e-5, atol=2e-4)
    g3_j, h3_j = jp.panel_vsweep(jnp.asarray(R_new, jdt), up, interpret=True,
                                 bm=8, bw=128)
    g3_t, h3_t = pk.panel_vsweep(_port_panel(R_new[:M, :W], tdt), t[1])
    for got, want in ((g3_t, g3_j), (h3_t, h3_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want)[:W],
                                   rtol=2e-5, atol=2e-4)


def _guarded_view(X: torch.Tensor, offset: int):
    """(buffer, view): X copied into a contiguous (M, W) view ``offset``
    elements into a buffer whose other cells hold a guard pattern."""
    M, W = X.shape
    buf = torch.full((M * W + offset + 19,), 0.3125, dtype=X.dtype)
    view = buf[offset:offset + M * W].view(M, W)
    view.copy_(X)
    assert view.is_contiguous() and view.storage_offset() == offset
    return buf, view


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_offset_view_matches_aligned_copy(kernel, tdt, offset):
    """A contiguous view at an odd element offset (its rows off every
    16-byte boundary) stores the same bits and gives the same g and h as an
    aligned copy; the guard cells around it are untouched. On the CPU this
    holds the wrappers' plain path (its views and offsets); the card's
    kernel is held to the same checks by chip_smoke.py's phase 3."""
    Rd, vecs = _inputs(21, 37, seed=offset)
    t = [torch.from_numpy(v) for v in vecs]
    X = _port_panel(Rd, tdt)
    buf, view = _guarded_view(X, offset)
    guard = buf.clone()
    if kernel == "K1":
        got, want = pk.panel_update_vsweep(view, *t), \
            pk.panel_update_vsweep(X, *t)
    else:
        got, want = pk.panel_vsweep(view, t[0]), pk.panel_vsweep(X, t[0])
    bits = torch.int16 if tdt == torch.bfloat16 else torch.int32
    assert torch.equal(view.view(bits), X.view(bits))
    n = X.numel()
    assert torch.equal(buf[:offset].view(bits), guard[:offset].view(bits))
    assert torch.equal(buf[offset + n:].view(bits),
                       guard[offset + n:].view(bits))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("M,W", [(1, 1), (19, 7), (512, 256), (513, 257),
                                 (330_128, 17_770), (13_464, 480_189),
                                 (40_000_000, 3)])
def test_sweep_geometry(M, W):
    """The column sweep's grid: 256-column strips covering W when shifted
    left by up to 63 columns (onto a 128-byte grid), row strips of a
    multiple of 8 rows, interleaved 64 to a band, the bands covering M
    within grid.y's limit, and one partial row of g and h per row strip."""
    rpp, nparts, nstrips = pk._sweep_geometry(M, W)
    assert pk._STRIP_COLS == 256 and pk._INTERLEAVE == 64
    assert (nstrips - 1) * 256 < W + 63 <= nstrips * 256
    assert rpp % 8 == 0 and rpp >= 512 and nparts <= 65_535
    bands = nparts // 64
    assert nparts % 64 == 0
    assert (bands - 1) * 64 * rpp < M <= bands * 64 * rpp
    if M * W <= 1 << 20:
        rpp_b, g, h, gpart, hpart = pk._sweep_buffers(torch.empty(M, W))
        assert rpp_b == rpp and g.shape == h.shape == (W,)
        assert gpart.shape == hpart.shape == (nparts, W)


def test_update_rounds_once_to_storage():
    """bf16 storage: the stored value is round-to-nearest-even of the f32
    sum R + (uo*vo - up*vp), and the sweep reads exactly what is stored."""
    Rd, (uo, up, vo, vp) = _inputs(40, 24, seed=3)
    Rt = _port_panel(Rd, torch.bfloat16)
    R0 = Rt.to(torch.float32)
    t = [torch.from_numpy(v) for v in (uo, up, vo, vp)]
    g, h = pk.panel_update_vsweep(Rt, *t)
    want = (R0 + (torch.outer(t[0], t[2]) - torch.outer(t[1], t[3]))
            ).to(torch.bfloat16)
    assert torch.equal(Rt.view(torch.int16), want.view(torch.int16))
    x = Rt.to(torch.float32)
    m = ~torch.isnan(x)
    torch.testing.assert_close(g, torch.where(m, x, 0.0).t() @ t[0],
                               rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(h, m.float().t() @ (t[0] * t[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["update", "vsweep", "usweep"])
def test_plain_versions_chunk_invariant(monkeypatch, name):
    """Row-chunking the plain versions (their memory bound) changes only
    the f32 summation order of g/h, never the stored residual."""
    Rd, (uo, up, vo, vp) = _inputs(37, 19, seed=11)
    t = [torch.from_numpy(v) for v in (uo, up, vo, vp)]
    outs = []
    for cells in (1 << 26, 50):
        monkeypatch.setattr(pk, "_PLAIN_CHUNK_CELLS", cells)
        Rt = _port_panel(Rd, torch.float32)
        if name == "update":
            gh = pk.panel_update_vsweep_plain(Rt, *t)
        elif name == "vsweep":
            gh = pk.panel_vsweep_plain(Rt, t[0])
        else:
            gh = pk.panel_usweep_plain(Rt, t[2])
        outs.append((Rt, gh))
    (Ra, (ga, ha)), (Rb, (gb, hb)) = outs
    assert torch.equal(Ra.view(torch.int32), Rb.view(torch.int32))
    torch.testing.assert_close(ga, gb, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ha, hb, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "vec_len",
                                 "vec_dtype", "ndim"])
def test_wrappers_validate_inputs(bad):
    R = torch.zeros((6, 5))
    u, v = torch.zeros(6), torch.zeros(5)
    if bad == "dtype":
        R = R.to(torch.float16)
    elif bad == "contiguous":
        R = torch.zeros((5, 6)).t()
    elif bad == "vec_len":
        u = torch.zeros(7)
    elif bad == "vec_dtype":
        u = u.double()
    else:
        R = torch.zeros(30)
    with pytest.raises((TypeError, ValueError)):
        pk.panel_update_vsweep(R, u, u, v, v)
    with pytest.raises((TypeError, ValueError)):
        pk.panel_vsweep(R, u)
    if bad != "vec_len" and bad != "vec_dtype":
        with pytest.raises((TypeError, ValueError)):
            pk.panel_usweep(R, v)


def test_build_requires_nvcc(monkeypatch, tmp_path):
    """No CUDA compiler -> the build raises (nothing falls back to the
    plain versions on a CUDA device); the library name keys on the
    source and flags."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    for name in build.SIGNATURES:
        assert build.library_path(name) == build.library_path(name)
        assert build.library_path(name).startswith(str(tmp_path / "b"))


def test_rows_per_part_bounds_grid():
    """The column sweep's row strips (its grid.y: 64 interleaved strips a
    band of 64 x rows-per-strip rows) stay within CUDA's grid.y limit and
    are a function of the row count alone (deterministic reduction
    order)."""
    for M in (1, 50, 512, 513, 65_536, 480_189, 40_000_000):
        rpp = pk._rows_per_part(M)
        assert rpp % 8 == 0 and rpp >= 512
        for W in (1, 17_770):
            assert pk._sweep_geometry(M, W)[:2] == (
                rpp, 64 * -(-M // (64 * rpp)))
            assert pk._sweep_geometry(M, W)[1] <= 65_535


def test_jax_interpret_backend_is_cpu():
    """These comparisons run the Pallas kernels in interpret mode."""
    assert jax.default_backend() == "cpu"
