"""Port hybrid backend against the JAX package, per step and per run.

Step: both packages start from ONE state (the JAX package's state after an
outer step, carried across with ``hybrid_state_from_numpy``) and run one
more outer step at an f32 residual; the port must match JAX's
``make_hybrid_outer_step(panel_kernel=True)`` (Pallas in interpret mode) at
rtol 1e-4, atol 1e-5 (tests/test_hybrid.py:174: the kernels' f32
accumulation order differs from the einsum path's at ULP level).

Run: ``ccd_hybrid_train`` over the four panel budgets of
tests/test_hybrid.py:36-41 must pass golden_compare against the NumPy
reference at the reference's 10% bar (atol 1e-3) and track the JAX
package's RMSE trajectory within 1e-3; a bf16 residual tracks the golden
RMSE within 0.02 (tests/test_hybrid.py:221).

The JAX side compiles one outer step per configuration, which dominates
the time of this file, so each configuration's JAX trajectory is run once
per module (``_jax_steps``) and shared by the step, run and state tests.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_recommender_tpu.core.config import Config as JConfig
from cuda_recommender_tpu.solvers import ccd_hybrid as jh
from cuda_recommender_tpu_torch.core.config import Config
from cuda_recommender_tpu_torch.core.init import init_factors_np
from cuda_recommender_tpu_torch.data import datasets
from cuda_recommender_tpu_torch.data.sparse import from_coo, make_test
from cuda_recommender_tpu_torch.eval.metrics import calrmse_np, golden_compare
from cuda_recommender_tpu_torch.ops import launches
from cuda_recommender_tpu_torch.solvers import ccd_hybrid as th
from cuda_recommender_tpu_torch.solvers.hybrid_state import (
    hybrid_state_from_numpy, hybrid_state_to_numpy)
from cuda_recommender_tpu_torch.solvers.reference import ccd_reference

K = 6
KERNEL = dict(backend="hybrid", mask_dtype="nan", hybrid_panel_kernel=True)
BUDGETS = {
    "stair_and_tail": (100 * 120, (32, 16)),   # multi-panel stair + ELL tail
    "all_dense": (300 * 120, (32,)),           # budget covers everything
    "pure_ell": (0, ()),                       # no panels
    "one_panel_and_tail": (40 * 120, ()),      # one full-width panel + tail
}


@pytest.fixture(scope="module")
def data():
    """tests/conftest.py's small_data, from the port's own generator."""
    return datasets.synthetic(m=300, n=120, nnz=6000, seed=7)


@pytest.fixture(scope="module")
def golden(data):
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    W, H = W0.copy(), H0.copy()
    stats = ccd_reference(R, W, H, T, lambda_=0.1, maxiter=3)
    return W0, H0, W, H, stats


def _payload(s):
    """JAX step state -> checkpoint-style numpy payload (copies: the JAX
    step donates its buffers)."""
    Rds, vals_r, vals_c, W, H, up, vp = s
    out = {"W": np.array(W), "H": np.array(H), "u_pend": np.array(up),
           "v_pend": np.array(vp)}
    out.update({f"Rd_{i}": np.array(x) for i, x in enumerate(Rds)})
    out.update({f"vals_r_{i}": np.array(x) for i, x in enumerate(vals_r)})
    out.update({f"vals_c_{i}": np.array(x) for i, x in enumerate(vals_c)})
    return out


def _jax_steps(case, inner, rdt=jnp.float32):
    """The cached JAX trajectory of one configuration (see _run_jax)."""
    return _run_jax(case, inner, rdt)


@functools.lru_cache(maxsize=None)
def _run_jax(case, inner, rdt, nsteps=3):
    """Run ``nsteps`` JAX outer steps of budget ``case`` from the initial
    state of its ``ccd_hybrid_train`` (W0 in the plan's user order, H and
    the pending product zero); returns (plan, the payload after each
    step). Cached: callers must not modify the payloads."""
    R, _ = datasets.synthetic(m=300, n=120, nnz=6000, seed=7)
    cells, widths = BUDGETS[case]
    cfg = JConfig(k=K, lambda_=0.1, maxinneriter=inner, **KERNEL,
                  hybrid_dense_cells=cells, hybrid_panel_widths=widths)
    plan = jh.plan_hybrid(R, cfg, materialize_dense=False)
    Rds, _ = jh.densify_panels(plan, rdt, mask_dtype="nan", block_pad=True)
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
    step = jh.make_hybrid_outer_step(plan, 0.1, inner, residual_dtype=rdt,
                                     nan_mask=True, panel_kernel=True)
    out = []
    for _ in range(nsteps):
        s = step(idx_r, idx_c, s[0], (), s[1], s[2], s[3], s[4], s[5], s[6],
                 *consts)
        out.append(_payload(s))
    return plan, tuple(out)


def _port_step(R, cfg_kw, inner, payload):
    cfg = Config(k=K, lambda_=0.1, maxinneriter=inner, **KERNEL, **cfg_kw)
    plan = th.plan_hybrid(R, cfg, materialize_dense=False)
    state = hybrid_state_from_numpy(payload, plan, "cpu")
    step = th.make_hybrid_outer_step(plan, th.device_plan(plan, "cpu"), 0.1,
                                     inner, order="once")
    step(state)
    return plan, state


def _assert_payload_close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        g, w = got[key], np.asarray(want[key], np.float32)
        assert g.shape == w.shape, key
        assert np.array_equal(np.isnan(g), np.isnan(w)), key
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("case,inner", [("stair_and_tail", 1),
                                        ("stair_and_tail", 2),
                                        ("all_dense", 1), ("pure_ell", 1)])
def test_outer_step_matches_jax(data, case, inner):
    R, _ = data
    cells, widths = BUDGETS[case]
    kw = dict(hybrid_dense_cells=cells, hybrid_panel_widths=widths)
    _, (p1, p2, _) = _jax_steps(case, inner)
    plan, state = _port_step(R, kw, inner, p1)
    got = hybrid_state_to_numpy(
        state, panel_shapes=[p2[f"Rd_{i}"].shape
                             for i in range(len(plan.panels))])
    _assert_payload_close(got, p2)
    assert np.abs(p2["u_pend"]).max() > 0       # a non-trivial pending state


@pytest.mark.parametrize("case", sorted(BUDGETS))
def test_train_golden_and_jax_trajectory(data, golden, case):
    R, T = data
    W0, H0, Wr, Hr, stats_r = golden
    cells, widths = BUDGETS[case]
    kw = dict(k=K, maxiter=3, lambda_=0.1, hybrid_dense_cells=cells,
              hybrid_panel_widths=widths, **KERNEL)
    launches.reset_launch_counts()
    W, H, stats = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T,
                                      Config(**kw), device="cpu")
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 1e-3
    # the JAX package's trajectory: its RMSE after each of its 3 outer
    # steps, with its factors back in the original entity order
    plan_j, payloads = _jax_steps(case, 1)
    rmse_j = [calrmse_np(T, p["W"][:, plan_j.user_pos],
                         p["H"][:, plan_j.item_pos], entity_major=False)
              for p in payloads]
    assert len(stats) == len(rmse_j) == 3
    for a, b in zip(stats, rmse_j):
        assert abs(a.rmse - b) < 1e-3
    assert sum(launches.launch_counts().values()) == 0      # CPU: plain versions


def test_bf16_residual_tracks_golden(data, golden):
    R, T = data
    W0, H0, _, _, stats_r = golden
    cfg = Config(k=K, maxiter=3, lambda_=0.1, hybrid_dense_cells=100 * 120,
                 hybrid_panel_widths=(32, 16), residual_dtype="bfloat16",
                 **KERNEL)
    W, H, stats = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                      device="cpu")
    assert np.isfinite(W).all() and np.isfinite(H).all()
    for a, b in zip(stats, stats_r):
        assert abs(a.rmse - b.rmse) < 0.02


def test_inner_iterations_golden(data):
    """-T 2 exercises K3 (the read-only v-sweep) and fused_sweep."""
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=2, maxinneriter=2)
    cfg = Config(k=K, maxiter=2, maxinneriter=2, lambda_=0.1,
                 hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16),
                 **KERNEL)
    W, H, _ = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                  device="cpu")
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed


@pytest.mark.parametrize("cells", [2 * 5, 6 * 5])
def test_empty_entities_zero_lambda(cells):
    """Empty rows/cols with λ=0 give exact-0 factors, never NaN, in both
    parts of the split (src/CCD.cpp:8)."""
    R = from_coo(6, 5, [0, 1, 1, 3], [0, 1, 2, 0], [4.0, 3.0, 5.0, 2.0])
    T = make_test(6, 5, [0], [0], [4.0])
    W0, H0 = init_factors_np(3, 6, 5, seed=0)
    cfg = Config(k=3, maxiter=2, lambda_=0.0, hybrid_dense_cells=cells,
                 hybrid_panel_widths=(), **KERNEL)
    W, H, _ = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                  device="cpu")
    assert np.all(W[:, [2, 4, 5]] == 0)
    assert np.all(H[:, [3, 4]] == 0)
    assert np.isfinite(W).all() and np.isfinite(H).all()


def test_maxiter_zero(data):
    R, T = data
    W0, H0 = init_factors_np(K, R.rows, R.cols, seed=0)
    cfg = Config(k=K, maxiter=0, hybrid_dense_cells=100 * 120,
                 hybrid_panel_widths=(32,), **KERNEL)
    W, H, stats = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                      device="cpu")
    assert stats == []
    np.testing.assert_array_equal(W, W0)
    assert not H.any()


def test_rank_one(data):
    R, T = data
    W0, H0 = init_factors_np(1, R.rows, R.cols, seed=0)
    Wr, Hr = W0.copy(), H0.copy()
    stats_r = ccd_reference(R, Wr, Hr, T, lambda_=0.1, maxiter=2)
    cfg = Config(k=1, maxiter=2, lambda_=0.1, hybrid_dense_cells=100 * 120,
                 hybrid_panel_widths=(32,), **KERNEL)
    W, H, stats = th.ccd_hybrid_train(R, W0.copy(), H0.copy(), T, cfg,
                                      device="cpu")
    assert W.shape == (1, R.rows) and H.shape == (1, R.cols)
    assert golden_compare(W, Wr, atol=1e-3).passed
    assert golden_compare(H, Hr, atol=1e-3).passed
    assert abs(stats[-1].rmse - stats_r[-1].rmse) < 1e-3


@pytest.mark.parametrize("rdt", [jnp.float32, jnp.bfloat16])
def test_state_round_trip(data, rdt):
    """to_numpy(from_numpy(x)) == x for the JAX package's block-padded
    payload, NaN sentinels included; bf16 panels keep their bits."""
    R, _ = data
    kw = dict(hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16))
    _, (p1, *_) = _jax_steps("stair_and_tail", 1, rdt)
    plan = th.plan_hybrid(R, Config(k=K, **KERNEL, **kw),
                          materialize_dense=False)
    state = hybrid_state_from_numpy(p1, plan, "cpu")
    want_dt = torch.bfloat16 if rdt == jnp.bfloat16 else torch.float32
    assert all(Rd.dtype == want_dt for Rd in state.Rds)
    assert [tuple(Rd.shape) for Rd in state.Rds] == [
        (r1 - r0, w) for r0, r1, w in plan.panels]
    back = hybrid_state_to_numpy(
        state, panel_shapes=[p1[f"Rd_{i}"].shape
                             for i in range(len(plan.panels))])
    assert sorted(back) == sorted(p1)
    for key, x in p1.items():
        x32 = np.asarray(x, np.float32)
        assert back[key].shape == x32.shape, key
        assert np.array_equal(back[key], x32, equal_nan=True), key


def test_state_from_numpy_rejects_observed_padding(data):
    R, _ = data
    kw = dict(hybrid_dense_cells=100 * 120, hybrid_panel_widths=(32, 16))
    _, (p1, *_) = _jax_steps("stair_and_tail", 1)
    plan = th.plan_hybrid(R, Config(k=K, **KERNEL, **kw),
                          materialize_dense=False)
    r0, r1, w = plan.panels[0]
    bad = dict(p1)
    bad["Rd_0"] = np.pad(p1["Rd_0"][:r1 - r0, :w], ((0, 1), (0, 0)),
                         constant_values=1.0)
    with pytest.raises(ValueError, match="must all be NaN"):
        hybrid_state_from_numpy(bad, plan, "cpu")
