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

SHAPES = [(48, 64, 16, 32), (50, 70, 16, 32), (16, 128, 16, 128)]
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
    """The column-sum strips stay within CUDA's grid.y limit and are a
    function of the row count alone (deterministic reduction order)."""
    for M in (1, 50, 512, 513, 65_536, 480_189, 40_000_000):
        rpp = pk._rows_per_part(M)
        assert rpp % 8 == 0 and rpp >= 512
        assert -(-M // rpp) <= 65_535


def test_jax_interpret_backend_is_cpu():
    """These comparisons run the Pallas kernels in interpret mode."""
    assert jax.default_backend() == "cpu"
