"""Port dense and pallas backends (K4 and the masked sweeps) against the JAX
package, per kernel, per step and per run.

Kernel: the same NumPy-seeded inputs go through the JAX package's Pallas
kernel ``ops/ccd_pallas.py::fused_update_vsweep`` (interpret mode on the
CPU, bm=8, bn=128) and the port's ``ops/ccd_kernels.py`` wrappers, which on
CPU tensors take their plain PyTorch versions (the CUDA kernels' oracle on
the card, chip_smoke.py). Tolerances: f32 stored residual rtol 2e-6, atol
2e-6 (XLA on the CPU contracts the delta into an FMA, the port rounds each
product, as tests/test_torch_panel_kernels.py found for K1); bf16 stored
residual within one bf16 ULP (those two f32 sums can round apart); g and h
rtol 2e-5, atol 2e-4 (blocked vs chunked f32 accumulation order,
tests/test_pallas.py:33-35).

Step: both packages start from ONE state (the JAX state after an outer
step, carried across with ``dense_state_from_numpy``) and run one more
outer step at an f32 residual: rtol 1e-4, atol 1e-5 (the JAX dense step
sweeps with XLA einsums, the port with K4's plain version; f32 summation
order differs at ULP level).

Run: ``ccd_dense_train`` / ``ccd_pallas_train`` pass golden_compare against
the NumPy reference at the reference's 10% bar with atol 1e-3 and track the
JAX functions' RMSE within 1e-3 (tests/test_compiled_solvers.py:38-51,
tests/test_pallas.py:38-51); a bf16 residual tracks the golden RMSE within
0.02 (tests/test_compiled_solvers.py:133-143).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.ops import ccd_pallas as jk
from cuda_recommender_tpu.solvers import ccd_dense as jd
from cuda_recommender_tpu.solvers import ccd_pallas as jpl
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.core.config import Backend
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.sparse import from_coo, make_test
from cuda_recommender_tpu_torch.eval.metrics import (golden_compare,
                                                     strict_misses)
from cuda_recommender_tpu_torch.ops import ccd_kernels as ck
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.ops.densify import densify_coo_mask
from cuda_recommender_tpu_torch.solvers import ccd_dense as td
from cuda_recommender_tpu_torch.solvers import ccd_pallas as tpl
from cuda_recommender_tpu_torch.solvers.dense_state import (
    dense_state_from_numpy, dense_state_to_numpy)
from cuda_recommender_tpu_torch.solvers.reference import ccd_reference

K = 6
DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]
MASKS = [torch.bfloat16, torch.int8]


def _small():
    """tests/conftest.py's small_data, from the port's own generator."""
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


@pytest.fixture(scope="module")
def data():
    return _small()


@pytest.fixture(scope="module")
def golden(data):
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    W, H = W0.copy(), H0.copy()
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=3)
    return W0, H0, W, H, stats


# ------------------------------------------------------------------ kernels

def _inputs(m, n, seed):
    """A residual that is 0 off a 30% mask, the mask, four factor vectors."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((m, n)) < 0.3).astype(np.float32)
    R = (rng.normal(size=(m, n)) * mask).astype(np.float32)
    vecs = [rng.normal(size=s).astype(np.float32) for s in (m, m, n, n)]
    return R, mask, vecs


def _pad(x, shape):
    out = np.zeros(shape, x.dtype)
    out[tuple(slice(0, s) for s in x.shape)] = x
    return out


def _jax_k4(R, mask, vecs, jdt, bm=8, bn=128):
    """The Pallas kernel on inputs zero-padded to its blocks; returns the
    stored residual (as f32 numpy) and g, h, trimmed to the true shape."""
    m, n = R.shape
    mp, np_ = -(-m // bm) * bm, -(-n // bn) * bn
    ua, us, va, vs = vecs
    Rn, g, h = jk.fused_update_vsweep(
        jnp.asarray(_pad(R, (mp, np_)), jdt),
        jnp.asarray(_pad(mask, (mp, np_)), jnp.bfloat16),
        jnp.asarray(_pad(ua, (mp,))), jnp.asarray(_pad(us, (mp,))),
        jnp.asarray(_pad(va, (np_,))), jnp.asarray(_pad(vs, (np_,))),
        interpret=True, bm=bm, bn=bn, alias=False)
    return (np.array(jnp.asarray(Rn).astype(jnp.float32))[:m, :n],
            np.asarray(g)[:n], np.asarray(h)[:n])


def _assert_residual(port, ref, name):
    """Port residual (torch) vs the JAX one (f32 numpy of the stored
    dtype's values): f32 within rtol/atol 2e-6, bf16 within one ULP."""
    if name == "float32":
        np.testing.assert_allclose(port.numpy(), ref, rtol=2e-6, atol=2e-6)
    else:
        gb = port.view(torch.int16).numpy().astype(np.int32)
        rb = (torch.from_numpy(ref).to(torch.bfloat16).view(torch.int16)
              .numpy().astype(np.int32))
        assert np.abs(gb - rb).max(initial=0) <= 1


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("mdt", MASKS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("m,n", [(16, 128), (48, 256), (50, 70)])
def test_fused_update_vsweep_matches_pallas(m, n, name, jdt, tdt, mdt):
    """K4's plain version against the Pallas kernel, aligned and ragged
    (the JAX side gets zero padding, the port the true shape)."""
    R, mask, vecs = _inputs(m, n, seed=m * n)
    R_j, g_j, h_j = _jax_k4(R, mask, vecs, jdt)
    launches.reset_launch_counts()
    Rt = torch.from_numpy(R).to(tdt)
    Mt = torch.from_numpy(mask).to(mdt)
    g_t, h_t = ck.fused_update_vsweep(Rt, Mt, *map(torch.from_numpy, vecs))
    _assert_residual(Rt, R_j, name)
    _close(g_t, g_j)
    _close(h_t, h_j)
    assert not Rt.to(torch.float32)[Mt == 0].any()   # unobserved stay 0
    assert set(launches.launch_counts().values()) == {0}   # CPU: plain


@pytest.mark.parametrize("mdt", MASKS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
@pytest.mark.parametrize("n", list(range(1, 18)))
def test_fused_update_vsweep_every_alignment(n, name, jdt, tdt, mdt):
    """K4's plain version (the card's oracle) against the Pallas kernel at
    widths of every residue mod 16 (the card's kernel moves 8 cells a lane
    in 16-byte vectors, the int8 mask in 8-byte ones, so rows start off
    their vector boundaries in as many ways), n < 8 and n = 1 among them,
    19 rows."""
    R, mask, vecs = _inputs(19, n, seed=n)
    R_j, g_j, h_j = _jax_k4(R, mask, vecs, jdt)
    Rt = torch.from_numpy(R).to(tdt)
    Mt = torch.from_numpy(mask).to(mdt)
    g_t, h_t = ck.fused_update_vsweep(Rt, Mt, *map(torch.from_numpy, vecs))
    _assert_residual(Rt, R_j, name)
    _close(g_t, g_j)
    _close(h_t, h_j)
    assert not Rt.to(torch.float32)[Mt == 0].any()   # unobserved stay 0


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("mdt", MASKS)
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["K4", "masked_vsweep"])
def test_offset_views_match_aligned_copies(kernel, tdt, mdt, offset):
    """Residual and mask as contiguous views at odd element offsets (rows
    off every vector boundary) store the same bits and give the same g and
    h as aligned copies; the residual's guard cells are untouched. On the
    CPU this holds the wrappers' plain path (its views and offsets); the
    card's kernel is held to the same checks by chip_smoke.py's phase 3."""
    R, mask, (ua, us, va, vs) = _inputs(21, 37, seed=offset)
    X, Mk = torch.from_numpy(R).to(tdt), torch.from_numpy(mask).to(mdt)
    n = X.numel()
    buf = torch.full((n + offset + 19,), 0.3125, dtype=tdt)
    view = buf[offset:offset + n].view(X.shape)
    view.copy_(X)
    mbuf = torch.zeros(n + offset + 2, dtype=mdt)
    mview = mbuf[offset + 1:offset + 1 + n].view(X.shape)
    mview.copy_(Mk)
    guard = buf.clone()
    vecs = [torch.from_numpy(v) for v in (ua, us, va, vs)]
    if kernel == "K4":
        got = ck.fused_update_vsweep(view, mview, *vecs)
        want = ck.fused_update_vsweep(X, Mk, *vecs)
    else:
        got = ck.masked_vsweep(view, mview, vecs[0])
        want = ck.masked_vsweep(X, Mk, vecs[0])
    bits = torch.int16 if tdt == torch.bfloat16 else torch.int32
    assert view.storage_offset() == offset and view.is_contiguous()
    assert torch.equal(view.view(bits), X.view(bits))
    assert torch.equal(buf[:offset].view(bits), guard[:offset].view(bits))
    assert torch.equal(buf[offset + n:].view(bits),
                       guard[offset + n:].view(bits))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mdt", MASKS)
@pytest.mark.parametrize("name,jdt,tdt", DTYPES)
def test_masked_sweeps_match_half_sweep(name, jdt, tdt, mdt):
    """masked_vsweep / masked_usweep partials, divided by the port's
    _half_sweep, against the JAX package's ``_half_sweep`` (the XLA sweeps
    they replace) on one shared residual; λ·nnz as in the dense step."""
    R, mask, (u, _, v, _) = _inputs(50, 70, seed=5)
    Rs = np.array(jnp.asarray(R, jdt).astype(jnp.float32))   # stored values
    row_nnz, col_nnz = mask.sum(1), mask.sum(0)
    Rj, Mj = jnp.asarray(Rs, jdt), jnp.asarray(mask, jnp.bfloat16)
    vj = jd._half_sweep(jnp.asarray(u), Rj, Mj, jnp.float32(0.1),
                        jnp.asarray(col_nnz))
    uj = jd._half_sweep(jnp.asarray(v), Rj.T, Mj.T, jnp.float32(0.1),
                        jnp.asarray(row_nnz))
    Rt = torch.from_numpy(Rs).to(tdt)
    Mt = torch.from_numpy(mask).to(mdt)
    vt = td._half_sweep(*ck.masked_vsweep(Rt, Mt, torch.from_numpy(u)), 0.1,
                        torch.from_numpy(col_nnz))
    ut = td._half_sweep(*ck.masked_usweep(Rt, Mt, torch.from_numpy(v)), 0.1,
                        torch.from_numpy(row_nnz))
    _close(vt, np.asarray(vj))
    _close(ut, np.asarray(uj))


def test_k4_sweeps_the_unrounded_sum():
    """bf16 residual: K4 stores round(s) once, s = R + fl(fl(ua·va −
    us·vs)·m), but its v-sweep reads s itself (ccd_pallas.py:50 reads the
    f32 block), unlike K1 which sweeps the stored value."""
    R, mask, vecs = _inputs(40, 24, seed=3)
    ua, us, va, vs = map(torch.from_numpy, vecs)
    Rt = torch.from_numpy(R).to(torch.bfloat16)
    Mt = torch.from_numpy(mask).to(torch.bfloat16)
    s = Rt.to(torch.float32) + (torch.outer(ua, va) - torch.outer(us, vs)
                                ) * Mt.to(torch.float32)
    g, h = ck.fused_update_vsweep(Rt, Mt, ua, us, va, vs)
    assert torch.equal(Rt.view(torch.int16), s.to(torch.bfloat16)
                       .view(torch.int16))
    torch.testing.assert_close(g, s.t() @ ua, rtol=1e-6, atol=1e-6)
    stored = Rt.to(torch.float32).t() @ ua
    assert (g - stored).abs().max() > 1e-3       # the stored sum differs
    torch.testing.assert_close(h, Mt.float().t() @ (ua * ua), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("bad", ["mask_dtype", "mask_shape", "contiguous",
                                 "vec_len"])
def test_masked_wrappers_validate_inputs(bad):
    R = torch.zeros((6, 5))
    M = torch.zeros((6, 5), dtype=torch.bfloat16)
    u, v = torch.zeros(6), torch.zeros(5)
    if bad == "mask_dtype":
        M = M.to(torch.float32)
    elif bad == "mask_shape":
        M = torch.zeros((6, 4), dtype=torch.bfloat16)
    elif bad == "contiguous":
        M = torch.zeros((5, 6), dtype=torch.bfloat16).t()
    else:
        u = torch.zeros(7)
    with pytest.raises((TypeError, ValueError)):
        ck.fused_update_vsweep(R, M, u, u, v, v)
    with pytest.raises((TypeError, ValueError)):
        ck.masked_vsweep(R, M, u)
    if bad != "vec_len":
        with pytest.raises((TypeError, ValueError)):
            ck.masked_usweep(R, M, v)


@pytest.mark.parametrize("mask_dtype", ["bfloat16", "int8"])
def test_device_densify_matches_jax_host_densify(data, mask_dtype):
    """The port's densify gives the JAX package's host-side
    ``build_dense_inputs`` arrays (an explicit 0 rating stays observed in
    the mask)."""
    R, _ = data
    Rd, Md = td.device_densify(R, torch.float32, mask_dtype, "cpu")
    want_r, want_m = jd.build_dense_inputs(R, np.float32)
    np.testing.assert_array_equal(Rd.numpy(), want_r)
    np.testing.assert_array_equal(Md.to(torch.float32).numpy(), want_m)


@pytest.mark.parametrize("mask_dtype,tdt", [("bfloat16", torch.bfloat16),
                                            ("int8", torch.int8)])
def test_densify_mask_mode(mask_dtype, tdt):
    """A zero residual with the ratings and a {0,1} mask, like the JAX
    package's explicit-mask densify_coo."""
    lr, lc, lv = np.array([0, 2, 1]), np.array([1, 0, 3]), np.array(
        [4.5, 0.0, -1.25], np.float32)
    Rd, Md = densify_coo_mask(lr, lc, lv, 3, 4, torch.float32, mask_dtype,
                              "cpu")
    want, want_m = np.zeros((3, 4), np.float32), np.zeros((3, 4), np.float32)
    want[lr, lc] = lv
    want_m[lr, lc] = 1.0           # an explicit 0.0 rating stays observed
    assert Md.dtype == tdt and Rd.dtype == torch.float32
    np.testing.assert_array_equal(Rd.numpy(), want)
    np.testing.assert_array_equal(Md.to(torch.float32).numpy(), want_m)
    with pytest.raises(ValueError):
        densify_coo_mask(lr, lc, lv, 3, 4, torch.float32, "nan", "cpu")


# -------------------------------------------------------------------- steps

@functools.lru_cache(maxsize=None)
def _jax_payloads(backend, inner, nsteps=2, residual=jnp.float32):
    """``nsteps`` JAX outer steps of the dense (XLA) or pallas (Pallas in
    interpret mode, block-padded) backend from its initial state; returns
    the payload after each. Cached: callers must not modify them."""
    R, _ = _small()
    m, n = R.rows, R.cols
    if backend == "pallas":
        mp, np_ = -(-m // jk.BM) * jk.BM, -(-n // jk.BN) * jk.BN
        step = jpl.make_pallas_outer_step(0.1, inner, interpret=True)
    else:
        mp, np_ = m, n
        step = jd.make_outer_step(0.1, inner)
    Rd, mask = jd._device_densify(R, mp, np_, residual, mdt="bfloat16")
    W0, _ = init_factors_np(K, m, n, seed=0)
    s = jd.DenseState(Rhat=Rd, W=jnp.asarray(_pad(W0, (K, mp))),
                      H=jnp.zeros((K, np_)), u_pend=jnp.zeros(mp),
                      v_pend=jnp.zeros(np_))
    row_nnz = jnp.asarray(_pad(np.diff(R.csr_ptr).astype(np.float32), (mp,)))
    col_nnz = jnp.asarray(_pad(np.diff(R.csc_ptr).astype(np.float32),
                               (np_,)))
    out = []
    for _ in range(nsteps):
        s = step(s, mask, row_nnz, col_nnz)
        out.append({key: np.array(getattr(s, key)) for key in
                    ("Rhat", "W", "H", "u_pend", "v_pend")})
    return tuple(out)


@pytest.mark.parametrize("backend,inner,mask_dtype",
                         [("dense", 1, "bfloat16"), ("dense", 2, "bfloat16"),
                          ("dense", 1, "int8"), ("pallas", 1, "bfloat16"),
                          ("pallas", 2, "bfloat16")])
def test_outer_step_matches_jax(data, backend, inner, mask_dtype):
    R, _ = data
    p1, p2 = _jax_payloads(backend, inner)
    state = dense_state_from_numpy(p1, (R.rows, R.cols), torch.float32,
                                   "cpu")
    _, mask = td.device_densify(R, torch.float32, mask_dtype, "cpu")
    # an f32 residual stores once on either backend
    make = (tpl.make_pallas_outer_step if backend == "pallas" else
            functools.partial(td.make_outer_step, order="once"))
    rnz = torch.from_numpy(np.diff(R.csr_ptr).astype(np.float32))
    cnz = torch.from_numpy(np.diff(R.csc_ptr).astype(np.float32))
    make(0.1, inner)(state, mask, rnz, cnz)
    got = dense_state_to_numpy(state, shape=p2["Rhat"].shape)
    assert sorted(got) == sorted(p2)
    for key in p2:
        assert got[key].shape == p2[key].shape, key
        np.testing.assert_allclose(got[key], p2[key], rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    assert np.abs(p2["u_pend"]).max() > 0       # a non-trivial pending state


@pytest.mark.parametrize("inner", [1, 2])
def test_outer_step_bf16_matches_jax_pallas(data, inner):
    """At a bf16 residual the port's step follows the JAX pallas schedule
    (K4 rounds the f32 sum once and sweeps that sum), the one both of the
    port's dense-family backends run. One outer step from one JAX pallas
    state. Tolerances: at most 1% of the observed cells may store another
    bf16 value, each within 4e-3 (XLA on the CPU contracts the Pallas
    kernel's delta into an FMA, so a few f32 sums round to neighbouring
    bf16 values; at |r| < 1 one ULP is at most 2^-8 ≈ 3.9e-3); the factors
    and pending vectors within rtol 1e-2, atol 2e-4 (those cells steer the
    following ranks by a few bf16 rounding steps of 2^-8)."""
    R, _ = data
    p1, p2 = _jax_payloads("pallas", inner, residual=jnp.bfloat16)
    state = dense_state_from_numpy(p1, (R.rows, R.cols), torch.bfloat16,
                                   "cpu")
    _, mask = td.device_densify(R, torch.bfloat16, "bfloat16", "cpu")
    rnz = torch.from_numpy(np.diff(R.csr_ptr).astype(np.float32))
    cnz = torch.from_numpy(np.diff(R.csc_ptr).astype(np.float32))
    tpl.make_pallas_outer_step(0.1, inner)(state, mask, rnz, cnz)
    got = dense_state_to_numpy(state, shape=p2["Rhat"].shape)
    want = {key: np.asarray(x, np.float32) for key, x in p2.items()}
    differ = got["Rhat"] != want["Rhat"]
    assert differ.sum() <= 0.01 * R.nnz
    np.testing.assert_allclose(got["Rhat"], want["Rhat"], rtol=0, atol=4e-3)
    for key in ("W", "H", "u_pend", "v_pend"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-2, atol=2e-4,
                                   err_msg=key)


# --------------------------------------------------------------------- runs

@functools.lru_cache(maxsize=None)
def _jax_run(backend, residual_dtype="float32", maxinneriter=1):
    R, T = _small()
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = JConfig(k=K, maxiter=3, maxinneriter=maxinneriter, lambda_=0.1,
                  backend=backend, residual_dtype=residual_dtype)
    fn = jpl.ccd_pallas_train if backend == "pallas" else jd.ccd_dense_train
    return fn(R, W0.copy(), H0.copy(), T, cfg)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_train_golden_and_jax_trajectory(data, golden, backend):
    R, T = data
    W0, H0, Wr, Hr, stats_r = golden
    cfg = Config(k=K, maxiter=3, lambda_=0.1, backend=backend)
    fn = tpl.ccd_pallas_train if backend == "pallas" else td.ccd_dense_train
    launches.reset_launch_counts()
    W, H, stats = fn(R, W0.copy(), H0.copy(), T, cfg, device="cpu")
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 1e-3
    _, _, stats_j = _jax_run(backend)
    assert len(stats) == len(stats_j) == 3
    for a, b in zip(stats, stats_j):
        assert abs(a.rmse - b.rmse) < 1e-3
    assert set(launches.launch_counts().values()) == {0}   # CPU: plain


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_bf16_residual_tracks_golden(data, golden, backend):
    R, T = data
    W0, H0, _, _, stats_r = golden
    cfg = Config(k=K, maxiter=3, lambda_=0.1, backend=backend,
                 residual_dtype="bfloat16")
    fn = tpl.ccd_pallas_train if backend == "pallas" else td.ccd_dense_train
    W, H, stats = fn(R, W0.copy(), H0.copy(), T, cfg, device="cpu")
    assert np.isfinite(W).all() and np.isfinite(H).all()
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 0.02
    _, _, stats_j = _jax_run(backend, "bfloat16")
    for a, b in zip(stats, stats_j):
        assert abs(a.rmse - b.rmse) < 0.02


def test_inner_iterations_golden(data):
    """-T 2 runs masked_vsweep (the inner iterations' v-sweep)."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=2, maxinneriter=2)
    cfg = Config(k=K, maxiter=2, maxinneriter=2, lambda_=0.1,
                 backend="dense")
    W, H, _ = td.ccd_dense_train(R, W0.copy(), H0.copy(), T, cfg,
                                 device="cpu")
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed


def test_mask_dtypes_identical(data):
    """A bf16 mask and an int8 mask give identical results ({0,1} is exact
    in both; tests/test_compiled_solvers.py:53-65)."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    outs = [td.ccd_dense_train(R, W0.copy(), H0.copy(), T,
                               Config(k=K, maxiter=3, lambda_=0.1,
                                      backend="dense", mask_dtype=mdt),
                               device="cpu") for mdt in ("bfloat16", "int8")]
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_pallas_equals_dense_and_ignores_mask_dtype(data):
    """The pallas backend is the dense backend with a bf16 mask: the same
    factors, whatever ``mask_dtype`` (and the hybrid's panel-kernel flag
    beside a NaN mask) says."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    base = dict(k=K, maxiter=2, lambda_=0.1)
    Wd, Hd, _ = td.ccd_dense_train(R, W0.copy(), H0.copy(), T,
                                   Config(backend="dense", **base),
                                   device="cpu")
    for extra in (dict(mask_dtype="int8"), dict(mask_dtype="nan"),
                  dict(mask_dtype="nan", hybrid_panel_kernel=True)):
        Wp, Hp, _ = tpl.ccd_pallas_train(
            R, W0.copy(), H0.copy(), T,
            Config(backend="pallas", **extra, **base), device="cpu")
        np.testing.assert_array_equal(Wp, Wd)
        np.testing.assert_array_equal(Hp, Hd)


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_empty_entities_zero_lambda(backend):
    """Empty rows/cols with λ=0 give exact-0 factors, never NaN
    (src/CCD.cpp:8; tests/test_compiled_solvers.py:158-173)."""
    R = from_coo(6, 5, [0, 1, 1, 3], [0, 1, 2, 0], [4.0, 3.0, 5.0, 2.0])
    T = make_test(6, 5, [0], [0], [4.0])
    W0, H0 = init_factors_np(3, 6, 5, seed=0)
    cfg = Config(k=3, maxiter=2, lambda_=0.0, backend=backend)
    fn = tpl.ccd_pallas_train if backend == "pallas" else td.ccd_dense_train
    W, H, _ = fn(R, W0.copy(), H0.copy(), T, cfg, device="cpu")
    assert np.all(W[:, [2, 4, 5]] == 0)
    assert np.all(H[:, [3, 4]] == 0)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_maxiter_zero(data):
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    W, H, stats = td.ccd_dense_train(R, W0.copy(), H0.copy(), T,
                                     Config(k=K, maxiter=0, backend="dense"),
                                     device="cpu")
    assert stats == []
    np.testing.assert_array_equal(W, W0)
    assert not H.any()


def test_rank_one(data):
    R, T = data
    W0, H0 = init_factors_np(1, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    stats_r = ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=2)
    W, H, stats = td.ccd_dense_train(
        R, W0.copy(), H0.copy(), T,
        Config(k=1, maxiter=2, lambda_=0.1, backend="dense"), device="cpu")
    assert W.shape == (1, R.rows) and H.shape == (1, R.cols)
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    assert abs(stats[-1].rmse - stats_r[-1].rmse) < 1e-3


def test_resume_equals_uninterrupted(data):
    """Three iterations equal one, then two more resumed from the JAX-style
    payload of the first (the residual and the pending product are state,
    src/CCD.cpp:100-134)."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = dict(k=K, lambda_=0.1, backend="dense")
    W3, H3, _ = td.ccd_dense_train(R, W0.copy(), H0.copy(), T,
                                   Config(maxiter=3, **cfg), device="cpu")
    p1 = dict(_jax_payloads("dense", 1)[0], oiter=1)
    W, H, stats = td.ccd_dense_train(R, W0.copy(), H0.copy(), T,
                                     Config(maxiter=3, **cfg), device="cpu",
                                     resume=p1)
    assert [s.oiter for s in stats] == [2, 3]
    np.testing.assert_allclose(W, W3, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(H, H3, rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------- state exchange

@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_state_round_trip(data, backend):
    """to_numpy(from_numpy(x)) == x, the pallas backend's block-padded
    payload included."""
    R, _ = data
    p1, _ = _jax_payloads(backend, 1)
    state = dense_state_from_numpy(p1, (R.rows, R.cols), torch.float32,
                                   "cpu")
    assert tuple(state.Rhat.shape) == (R.rows, R.cols)
    assert tuple(state.W.shape) == (K, R.rows)
    assert tuple(state.H.shape) == (K, R.cols)
    back = dense_state_to_numpy(state, shape=p1["Rhat"].shape)
    assert sorted(back) == sorted(p1)
    for key, x in p1.items():
        assert back[key].shape == x.shape, key
        assert np.array_equal(back[key], x), key


def test_state_bf16_keeps_bits(data):
    R, _ = data
    p1, _ = _jax_payloads("dense", 1)
    bf = dict(p1, Rhat=np.array(jnp.asarray(p1["Rhat"], jnp.bfloat16)))
    state = dense_state_from_numpy(bf, (R.rows, R.cols), torch.bfloat16,
                                   "cpu")
    assert state.Rhat.dtype == torch.bfloat16
    np.testing.assert_array_equal(dense_state_to_numpy(state)["Rhat"],
                                  np.asarray(bf["Rhat"], np.float32))


@pytest.mark.parametrize("where", ["Rhat_rows", "Rhat_cols", "W", "v_pend"])
def test_state_rejects_nonzero_padding(data, where):
    R, _ = data
    p1, _ = _jax_payloads("pallas", 1)
    m, n = R.rows, R.cols
    bad = {key: np.array(x) for key, x in p1.items()}
    if where == "Rhat_rows":
        bad["Rhat"][m, 0] = 1.0
    elif where == "Rhat_cols":
        bad["Rhat"][0, n] = 1.0
    elif where == "W":
        bad["W"][0, m] = 1.0
    else:
        bad["v_pend"][n] = 1.0
    with pytest.raises(ValueError, match="must all be 0"):
        dense_state_from_numpy(bad, (m, n), torch.float32, "cpu")


# ------------------------------------------------------- trainer and the CLI

def test_auto_resolves_to_dense_at_readme_sizes():
    """The README quick start's ml10M dims (and the CLI example's) fit
    ``dense_max_cells``, so AUTO picks the dense backend."""
    assert Config().resolve_backend(69878, 10677) == Backend.DENSE
    assert Config().resolve_backend(6040, 3706) == Backend.DENSE
    assert Config().resolve_backend(480189, 17770) == Backend.HYBRID


def test_readme_quick_start_runs_on_cpu(capsys):
    """The README quick start's call (no backend or mask flags), at a
    hundredth of its dims, on the port: dense, golden PASS."""
    R, T = datasets.synthetic(m=699, n=107, nnz=10_000, seed=1)
    res = train(Config(k=10, maxiter=5, lambda_=0.05, golden=True), R, T,
                device="cpu")
    assert res.backend == "dense"
    assert res.golden_W.passed and res.golden_H.passed
    assert abs(res.final_rmse - res.ref_final_rmse) < 1e-3
    assert all(s.rmse < res.stats[0].rmse for s in res.stats[1:])
    assert "dense residual: 699 x 107" in capsys.readouterr().out


def test_cli_without_backend_flag_runs_dense(capsys):
    rc = cli.main(["--dataset", "synthetic:m=60,n=37,nnz=900", "-k", "4",
                   "-t", "2", "-l", "0.05", "--golden", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert any("Backend = dense" in x for x in out)
    assert out.count("Check... PASS!") == 2


def test_strict_misses_name_the_worst_entries():
    """The golden report's strict misses: the largest reference value and
    the largest error among the entries that miss the 10% bar (the chip
    smoke passes a strict miss only at a near-zero entry)."""
    ref = np.array([[0.5, 1e-6, -0.2], [3e-5, 0.1, 0.0]])
    got = np.array([[0.52, 3e-6, -0.2], [3e-5, 0.1, 1e-7]])
    assert strict_misses(ref, ref) == (0.0, 0.0)
    worst_ref, worst_diff = strict_misses(got, ref)
    assert not golden_compare(got, ref).passed
    assert worst_ref == pytest.approx(1e-6)       # 0.5 is within 10%
    assert worst_diff == pytest.approx(2e-6)
