"""Port pure-ELL CCD++ backend against the JAX package.

The ELL ops that phase mode and pure ELL add (``lanes_to_slots``,
``slots_to_lanes``, ``bucket_slot_ranges``, ``sweep_partials``,
``residual_update``) are plain torch in the port and XLA in the JAX package
(jitted here, as its solvers run them): held at rtol 1e-6 (f32, same
operation order up to summation). The phase sweep (``sweep_partials`` then
ccd_dense's ``_half_sweep``) is held to the JAX ``sweep_new_values`` at
rtol 1e-5.
Step: from ONE state (the JAX package's after an outer step, pending
product nonzero, carried across with ``ell_state_from_numpy``) one more
outer step matches JAX's ``make_ell_outer_step`` at rtol 1e-4, atol 1e-5.
Run: the RMSE trajectory within 1e-3 of JAX's, golden PASS against the
NumPy reference.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.data.ell import build_ell_pair as j_build_ell
from cuda_recommender_tpu.ops import ell_ops as jops
from cuda_recommender_tpu.solvers import ccd_ell as jell
from cuda_recommender_tpu_torch import Config, train
from cuda_recommender_tpu_torch.cli import train as cli
from cuda_recommender_tpu_torch.core.config import Backend
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.ell import build_ell_pair
from cuda_recommender_tpu_torch.models.mf import get_train_fn
from cuda_recommender_tpu_torch.ops import ell_ops
from cuda_recommender_tpu_torch.solvers import ccd_dense as td
from cuda_recommender_tpu_torch.solvers import ccd_ell
from cuda_recommender_tpu_torch.solvers.ell_state import (
    ell_state_from_numpy, ell_state_to_numpy)

K = 5
F32 = dict(rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def data():
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


@pytest.fixture(scope="module")
def ell(data):
    return build_ell_pair(data[0], min_width=8)


def _t(x, dtype=None):
    x = np.asarray(x)
    return torch.from_numpy(x.astype(dtype) if dtype else x.copy())


def _quiet(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def test_ell_layout_identical(data, ell):
    """The port's slot-space layout (the pure-ELL index space) is the JAX
    package's, bit for bit."""
    jell_pair = j_build_ell(data[0], min_width=8)
    for a, b in ((ell.rows_side, jell_pair.rows_side),
                 (ell.cols_side, jell_pair.cols_side)):
        assert a.n_slots == b.n_slots and len(a.buckets) == len(b.buckets)
        np.testing.assert_array_equal(a.slot_of_entity, b.slot_of_entity)
        for x, y in zip(a.buckets, b.buckets):
            np.testing.assert_array_equal(x.idx, y.idx)
            np.testing.assert_array_equal(x.val, y.val)


# ---- the new ELL ops against the JAX package's ----

@pytest.mark.parametrize("side_name", ["rows_side", "cols_side"])
def test_lane_slot_maps_and_ranges_match_jax(ell, side_name):
    side = getattr(ell, side_name)
    assert ell_ops.bucket_slot_ranges(side) == jops.bucket_slot_ranges(side)
    rng = np.random.default_rng(1)
    for b in side.buckets:
        lanes = rng.normal(size=b.val.shape).astype(np.float32)
        slots = rng.normal(size=b.rows * b.p).astype(np.float32)
        np.testing.assert_allclose(
            ell_ops.lanes_to_slots(_t(lanes), b).numpy(),
            np.asarray(jops.lanes_to_slots(jnp.asarray(lanes), b)), **F32)
        np.testing.assert_array_equal(
            ell_ops.slots_to_lanes(_t(slots), b).numpy(),
            np.asarray(jops.slots_to_lanes(jnp.asarray(slots), b)))


@pytest.mark.parametrize("side_name", ["rows_side", "cols_side"])
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_residual_update_matches_jax(ell, side_name, sign):
    side = getattr(ell, side_name)
    other = ell.cols_side if side_name == "rows_side" else ell.rows_side
    rng = np.random.default_rng(3)
    tab = rng.normal(size=other.n_slots).astype(np.float32)
    own = rng.normal(size=side.n_slots).astype(np.float32)
    idx = [b.idx for b in side.buckets]
    vals = [b.val for b in side.buckets]
    jv = jax.jit(lambda i, v, t, o: jops.residual_update(
        i, v, side, jops.extend_zero(t), o, sign))(
            tuple(jnp.asarray(i) for i in idx),
            tuple(jnp.asarray(v) for v in vals), jnp.asarray(tab),
            jnp.asarray(own))
    tv = [_t(v) for v in vals]
    ell_ops.residual_update([_t(i, np.int64) for i in idx], tv, side,
                            ell_ops.extend_zero(_t(tab)), _t(own), sign)
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)
        # padded lanes gather the zero slot and stay exactly 0
    assert all(not a.numpy()[i == other.n_slots].any()
               for a, i in zip(tv, idx))


@pytest.mark.parametrize("side_name", ["rows_side", "cols_side"])
@pytest.mark.parametrize("nmf", [False, True])
@pytest.mark.parametrize("lam", [0.1, 0.0])
def test_sweeps_match_jax(ell, side_name, nmf, lam):
    """sweep_partials, and the phase sweep's new values from them (λ·nnz,
    empty slots -> 0, the nmf clamp), against the JAX package's
    ``sweep_partials`` and ``sweep_new_values``."""
    side = getattr(ell, side_name)
    other = ell.cols_side if side_name == "rows_side" else ell.rows_side
    rng = np.random.default_rng(4)
    tab = rng.normal(size=other.n_slots).astype(np.float32)
    idx = tuple(jnp.asarray(b.idx) for b in side.buckets)
    vals = tuple(jnp.asarray(b.val) for b in side.buckets)
    jg, jh, _ = jops.sweep_partials(idx, vals, side,
                                    jops.extend_zero(jnp.asarray(tab)))
    jnew, _ = jops.sweep_new_values(idx, vals, side,
                                    jops.extend_zero(jnp.asarray(tab)),
                                    jnp.float32(lam),
                                    jnp.asarray(side.slot_nnz), nmf=nmf)
    tidx = [_t(b.idx, np.int64) for b in side.buckets]
    tvals = [_t(b.val) for b in side.buckets]
    tg, th = ell_ops.sweep_partials(tidx, tvals, side,
                                    ell_ops.extend_zero(_t(tab)))
    tnew = td._half_sweep(tg, th, lam, _t(side.slot_nnz), nmf)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **F32)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **F32)
    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew), rtol=1e-5,
                               atol=1e-6)
    assert not tnew.numpy()[side.slot_nnz == 0].any()


# ---- the backend ----

def _jax_state(data, ell, maxinneriter):
    """A shared state: the JAX package's after one outer step from the
    initial one (pending product nonzero)."""
    R, _ = data
    W0, _ = init_factors_np(K, R.rows, R.cols, seed=0)
    rows, cols = ell.rows_side, ell.cols_side
    step = jell.make_ell_outer_step(ell, 0.1, maxinneriter)
    idx_r = tuple(jnp.asarray(b.idx) for b in rows.buckets)
    idx_c = tuple(jnp.asarray(b.idx) for b in cols.buckets)
    s = step(idx_r, idx_c, tuple(jnp.asarray(b.val) for b in rows.buckets),
             tuple(jnp.asarray(b.val) for b in cols.buckets),
             jnp.asarray(jell.factors_to_slots(W0, rows)),
             jnp.zeros((K, cols.n_slots), jnp.float32),
             jnp.asarray(rows.slot_nnz), jnp.asarray(cols.slot_nnz),
             jnp.zeros(rows.n_slots, jnp.float32),
             jnp.zeros(cols.n_slots, jnp.float32))
    vals_r, vals_c, W, H, up, vp = s
    payload = {"W": np.asarray(W), "H": np.asarray(H),
               "u_pend": np.asarray(up), "v_pend": np.asarray(vp)}
    payload.update({f"vals_r_{i}": np.asarray(v)
                    for i, v in enumerate(vals_r)})
    payload.update({f"vals_c_{i}": np.asarray(v)
                    for i, v in enumerate(vals_c)})
    return payload, step, idx_r, idx_c


@pytest.mark.parametrize("inner", [1, 2])
def test_outer_step_matches_jax(data, ell, inner):
    payload, jstep, idx_r, idx_c = _jax_state(data, ell, inner)
    rows, cols = ell.rows_side, ell.cols_side
    assert payload["u_pend"].any() and payload["v_pend"].any()
    st = ell_state_from_numpy(payload, ell, "cpu")
    step = ccd_ell.make_ell_outer_step(
        ell, ccd_ell.side_tiles(rows, "cpu"), ccd_ell.side_tiles(cols, "cpu"),
        _t(rows.slot_nnz), _t(cols.slot_nnz), 0.1, inner)
    step(st)
    n_r, n_c = len(rows.buckets), len(cols.buckets)
    js = jstep(idx_r, idx_c,
               tuple(jnp.asarray(payload[f"vals_r_{i}"]) for i in range(n_r)),
               tuple(jnp.asarray(payload[f"vals_c_{i}"]) for i in range(n_c)),
               jnp.asarray(payload["W"]), jnp.asarray(payload["H"]),
               jnp.asarray(rows.slot_nnz), jnp.asarray(cols.slot_nnz),
               jnp.asarray(payload["u_pend"]), jnp.asarray(payload["v_pend"]))
    got = ell_state_to_numpy(st)
    tol = dict(rtol=1e-4, atol=1e-5)
    for key, want in (("W", js[2]), ("H", js[3]), ("u_pend", js[4]),
                      ("v_pend", js[5])):
        np.testing.assert_allclose(got[key], np.asarray(want), **tol)
    for i in range(n_r):
        np.testing.assert_allclose(got[f"vals_r_{i}"], np.asarray(js[0][i]),
                                   **tol)
    for i in range(n_c):
        np.testing.assert_allclose(got[f"vals_c_{i}"], np.asarray(js[1][i]),
                                   **tol)


def test_state_round_trip_and_layout_check(data, ell):
    payload, *_ = _jax_state(data, ell, 1)
    back = ell_state_to_numpy(ell_state_from_numpy(payload, ell, "cpu"))
    assert sorted(back) == sorted(payload)
    for key in payload:
        np.testing.assert_array_equal(back[key], payload[key])
    other = build_ell_pair(data[0], min_width=16)
    with pytest.raises(ValueError, match="does not fit this layout"):
        ell_state_from_numpy(payload, other, "cpu")


@pytest.mark.parametrize("inner", [1, 2])
def test_run_matches_jax_and_golden(data, inner):
    R, T = data
    cfg = dict(k=K, maxiter=3, maxinneriter=inner, lambda_=0.1,
               backend="ell")
    res, out = _quiet(lambda: train(Config(golden=True, **cfg), R, T,
                                    device="cpu"))
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    _, _, jstats = jell.ccd_ell_train(R, W0, H0, T, JConfig(**cfg))
    assert res.backend == "ell"
    assert res.golden_W.passed and res.golden_H.passed
    assert out.count("Check... PASS!") == 2
    for a, b in zip(res.stats, jstats):
        assert abs(a.rmse - b.rmse) < 1e-3
    assert [s.oiter for s in res.stats] == [1, 2, 3]
    assert "[info] ell plan: rows side" in out


def test_auto_picks_ell_when_no_panel_row_fits(data):
    """AUTO -> ELL when the matrix is above dense_max_cells and not one
    panel row fits the hybrid budget (core/config.py), as in JAX."""
    R, T = data
    kw = dict(k=3, maxiter=2, dense_max_cells=1000,
              hybrid_dense_cells=R.cols - 1)
    cfg = Config(**kw)
    assert cfg.resolve_backend(R.rows, R.cols) == Backend.ELL
    assert JConfig(**kw).resolve_backend(R.rows, R.cols).value == "ell"
    res, _ = _quiet(lambda: train(cfg, R, T, device="cpu"))
    assert res.backend == "ell" and np.isfinite(res.W).all()
    assert res.stats[-1].rmse < res.stats[0].rmse


def test_cli_backend_ell(tmp_path):
    rc, out = _quiet(lambda: cli.main([
        "--dataset", "synthetic:m=300,n=120,nnz=6000,seed=7", "-k", "4",
        "-t", "3", "-l", "0.1", "--backend", "ell", "--golden", "--device",
        "cpu"]))
    assert rc == 0
    assert "[info] Backend = ell |" in out
    assert out.count("Check... PASS!") == 2
    assert len([x for x in out.splitlines()
                if x.startswith("[-INFO-]")]) == 6


def test_mfmodel_trains_on_ell(data):
    """The registry's ell trainer feeds MFModel as the JAX package's does."""
    from cuda_recommender_tpu_torch.models.mf import MFModel

    R, T = data
    fn = get_train_fn("ccd", "ell")
    assert fn is ccd_ell.ccd_ell_train
    W0, H0 = init_factors_np(4, R.rows, R.cols, seed=0)
    W, H, stats = fn(R, W0, H0, T, Config(k=4, maxiter=2, backend="ell"),
                     device="cpu")
    model = MFModel.from_factors(W, H, entity_major=False)
    assert model.W.shape == (R.rows, 4) and model.H.shape == (R.cols, 4)
    pred = model.predict(T.row_idx[:5], T.col_idx[:5], device="cpu")
    np.testing.assert_allclose(pred, np.einsum(
        "ek,ek->e", model.W[T.row_idx[:5]], model.H[T.col_idx[:5]]),
        rtol=1e-5, atol=1e-6)
